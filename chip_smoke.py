"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch.  It imports nothing of JAX and nothing of the
JAX package ``repro``; it drives ``src/repro_torch`` in phases and prints
one JSON line after each (its ``t_s``: seconds since the start), failing
loudly on the first fault:

1. device   — a CUDA card must be present; prints its name and power
              limit (``nvidia-smi``).
2. build    — compiles every kernel of the port from
              ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
              once; also ``host_alloc.cu``, the page-locked blocks of the
              gain call) and prints the ``-Xptxas -v`` register / shared-
              memory / spill report, K1's, K2's, K3's and K4's float32
              route's in the build line.  Fails unless the float32
              route's entries spill nothing and ``cuobjdump -sass`` of its
              library shows tf32 ``HGMMA`` (``wgmma`` on the tensor cores)
              in its attention entry.
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
              the bytes.  Then both over the main graph shared by
              PORTFOLIO_LANES = 8 lanes (the portfolio's; seeded
              permutations, real weights): each lane bit-equal to a
              single launch and to the stacked launch of the graph
              copied once a lane; the device time per launch beside the
              8 single launches and the stacked launch.
3b. lint   — ``viem lint`` (``repro_torch.staticcheck``) on
              ``src/repro_torch``: 0 active and 0 unjustified findings;
              then its runtime audit on the card (``--runtime-audit
              --device cuda``): every registered construction on the five
              16-PE machines through ``execute``, ``execute_batch`` (2
              lanes) and the portfolio's shared-graph lanes under an op
              recorder and PyTorch's sync debug mode, every sync a
              counted read or a named upload, no copy between devices
              inside a counted loop, no floating intermediate off the
              plan's accumulator dtype; combos a construction cannot run
              are skipped, none may fail.
4. portfolio — ``Mapper(4:16:64 / 1:10:100, multilevel=MultilevelSpec(),
              preconfiguration="eco", portfolio=PortfolioSpec()).map(
              grid3d(16, 16, 16))``: 8 lanes constructed at n = 512 and
              refined in one sweep loop a level over the shared graph,
              then up to 4 kick → refine → tournament rounds at n =
              4096, with the launch counts set to 0 just before and read
              just after: a bijection, jf equal to the host float64
              objective, every observed sync a counted read (lane
              refinements, contractions, rounds; none in the upload of
              the starts and draws).  Prints the construction, pyramid,
              lane-refinement and round seconds, each round's incumbent
              J, kick ms, K1/K2 launches and reads, and jf beside the
              multilevel map's (ML_REFERENCE_LEVELS: lane 0 has its
              construction).
5. portfolio:cpu — a flat portfolio map on the torus (16, 16, 4), n =
              1024, 4 lanes, 3 rounds, 16 sweeps (PORTFOLIO_CPU: cut
              from 64 for the CPU side's time) on the card, and the same
              from the card's lane constructions on the CPU: equal bit
              for bit (permutation, objectives, trace, swaps).
6. main     — ``Mapper(4:16:64 / 1:10:100, MappingSpec(engine="device",
              backend="pallas"), device="cuda").map(grid3d(16, 16, 16))``
              with the launch counts set to 0 just before and read just
              after; checks the result (bijection, jf equals the host
              float64 objective, jf <= j0) and that the card's refinement
              equals the plain versions' on the CPU from the same start.
7. forms    — the same path on a torus and on a fat-tree distance matrix
              packed to int8, at n = 1024, each equal to the CPU
              refinement from the same start.
8. multilevel — the main call with ``multilevel=MultilevelSpec(),
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
9. batch    — ``map_many`` of 4 graphs at n = 4096 on the main machine
              under the same spec (3 stencils with seeded integer weights
              in [1, 100], one random geometric graph of about the
              stencil's mean degree), then a flat ``map_many`` of 4 at n
              = 1024 on the torus form: each result equal to its single
              card map, and the multilevel batch's levels up to n = 1024
              (which do swap) equal to the CPU refinement from the same
              starts; wall time per graph against the singles, K1/K2
              launches against the singles' sum, counted reads per
              sweep, each call's syncs all counted.
10. warm    — ``MappingPlan.execute_warm`` on the main map's result
              after a seeded drift (5 % of the vertices gain an edge to a
              seeded partner), the pairs touching them active: equal to
              the CPU warm refinement from the same incumbent, the
              incumbent unchanged, P unchanged, the inactive region
              frozen.
11. remap   — the closed loop (``repro_torch.monitor.RemapMonitor``) on
              the main cell: a ``pow2`` plan with the main map's spec,
              the main map's incumbent (no second construction), the
              candidate pairs built once and held fixed; 10 windows
              (REMAP): 4 quiet (±1 % jitter), then ×8 on the edges of a
              seeded 12.5 % of the vertices, and before window 8's tick a
              StragglerMonitor (4 hosts, patience 2) attached to the loop
              flags host 1, so a REBALANCE goes through the replay gate.
              Launch counts set to 0 just before the ticks and read just
              after.  Checks: the quiet windows trigger nothing; every
              warm remap launches K1 and K2, refines the fixed pair
              array (P unchanged), makes no sync but counted reads, and
              moves no vertex outside its active pairs; every committed
              incumbent is a bijection whose K1 objective is the host
              float64 one within REMAP's objective_rtol; the device-graph
              cache stays within its cap.  One line per tick: decision,
              drift score, dirty vertices, active pairs, remap seconds on
              the card, K1/K2 launches, reads and observed syncs, K1
              calls, predicted against actual (host float64)
              improvement.
12. remap:bench — ``benchmarks/bench_remap.py``'s full workload
              (BENCH_REMAP: ``grid3d(8, 8, 4)`` on the torus (16, 16),
              its three episodes) through the port on the card and on
              the CPU: decisions, dirty sets, active pairs and committed
              permutations equal, scores within 1e-6 relative; its
              acceptance (no quiet remap, recovery ≥ 0.8 of a scratch
              remap, incremental time < 0.5× the scratch ``plan.execute``
              on the card), printed beside BENCH_remap.json's CPU
              figures of the JAX package.
13. service — ``MappingService(Mapper(main machine, bench_port_serve's
              spec with backend="pallas"), **placement_service_config())``
              (pow2 buckets, max_batch 4, max_wait 5 ms): the batch
              cells' four n = 4096 graphs warmed once each on copies with
              weights ×1.5, then one timed burst — the four twice each,
              an n = 1024 graph (a size mismatch) and the first again as
              a "strong" request (``PortfolioSpec()``, 8 lanes over the
              shared graph) — with the launch counts set to 0 just before
              and read just after.  Checks one result per ticket, the
              mismatch a ValueError and the only error, every other
              result equal to the same Mapper's single ``map`` once the
              worker stopped (permutation equal, jf within 1e-6
              relative; the largest difference printed), a tick through
              ``execute_batch`` with K2 launched at 4 lanes, hits plus
              deduped = the 4 repeats, every sync of the worker's sweep
              and round loops a counted read, no tensor in a result,
              every served jf within 1e-5 relative of the host float64
              objective.  The plain versions at the service's shapes:
              the same burst through a ``MappingService`` on a
              ``device="cpu"`` Mapper (a batch tick of the same pow2
              lanes, the strong request's 8 lanes) must give the same
              permutations.  Prints the burst's requests per second
              and p50/p99 (gate readings of a 10-request burst, not the
              service's throughput or tail), the ticks, K1/K2 launches
              and the strong request's seconds (its ``plan.execute``
              span).
14. service:bench — ``benchmarks/bench_port_serve.py``'s full workload
              (``bench_serve``'s: ``tpu_v5e_fleet(pods=1)``, n = 256, 6
              structures × 8 repeats) on the card: no request fails,
              hits plus deduped = 42, the plan buckets
              BENCH_serve.json's; its payload and throughput speedup
              beside BENCH_serve.json's 4.94 (a CPU run of the JAX
              package).
15. placement — ``placement_service()`` started in this process: its
              Mapper resolves to the card and its engine is
              ``placement_spec()``'s host engine (no kernel runs there;
              ``--placement-smoke``'s lines are held to the JAX
              package's by the CPU tests).
16. gain    — ``Mapper(..., backend="pallas").gain_matrix(g, perm)`` on
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
17. flash   — holds K4 (flash attention) against its plain version on
              the card at the serve shape (B 4, T 2048, H 32, KV 8, hd
              128) and at starcoder2-7b's windowed shape (B 1, T 8192, H
              36, KV 4, hd 128, window 4096), each in bf16 and float32,
              and on small cases at float32 and bf16 (T ragged against
              both routes' tiles, T = 1, G = 1, MQA, one kv tile); every
              case must take its dtype's route (bf16:
              ``csrc/flash_attention_sm90.cu``, float32:
              ``csrc/flash_attention.cu``, both ``wgmma`` + TMA, the
              float32 one through a 3xTF32 split) and no other.  Times K4,
              its plain version and ``scaled_dot_product_attention`` (the
              yardstick; the port never calls it) beside the bound; a
              float32 record's bound is one TF32 pass on the tensor cores,
              with the 3xTF32 split's (three passes) and the CUDA cores'
              float32 bound beside it.  Then FLASH_REPEAT: the float32
              route at the granite smoke prefill's shape (q (2, 96, 4,
              32): 3 kv tiles through the 2-stage ring, whose refill
              runs) 256 times on fresh randn inputs, every launch within
              FLASH_F32_TOL of the plain version.
18. serve   — ``serve("granite-3-8b", batch=4, prompt_len=2048, gen=32)``
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
19. train:parity — granite-3-2b at full width (d 2048, 32/8 heads,
              vocab 49,408), 2 layers, float32: two ``train_step`` calls
              (batch 4 × 256 SyntheticLM tokens, 2 microbatches,
              ``OptConfig()``) on the card and on the CPU from one
              seeded initial state: losses and grad norms within 1e-5
              relative, every parameter, m and v within 1e-5 relative
              Frobenius error per tensor; K4 launched 0 times (training
              attends through the blocked twin), no host sync inside a
              step.
20. train   — ``launch.train``'s loop as ``train`` runs it
              (``train_model`` on ``make_local_mesh``: a (1, 1) mesh over
              a world-1 NCCL group, the sharded step on DTensors) for
              granite-3-2b, steps=3, global_batch=4, seq_len=4096,
              microbatches=4, at the published width and 20 of its 40
              layers (bf16, remat "full", seeded random weights;
              depth cut in PR 26 for the run's time limit) with the launch
              counts set to 0 just before and read just after: every loss
              and grad norm finite, the first loss within 1.0 of ln V,
              step 3, m nonzero in every tensor and every matrix moved,
              K4 launched 0 times, 0 host syncs inside every step (sync
              debug mode through ``host_boundary``), the batch uploads
              syncless and the log reads counted.  Then the same loop
              on the unsharded step (``train_model(..., mesh=None)``) at
              the same depth, steps and batch.  Prints the per-step
              seconds of both (median of steps 2–3) and their ratio (the
              1-rank DTensor path's cost), tokens/s, MFU against the bf16
              dense peak, peak memory, the losses, PR 25's 40-layer
              unsharded step seconds under their own name, and one more
              unsharded step's device time split (``train_split``) into
              the blocked attention, the other matmuls, AdamW and the
              rest.
21. train:checkpoint — the train:parity shape in bf16: 2 steps,
              ``save_async``, 2 more (A); a fresh state restored from
              step 2 (equal to the saved one bit for bit) and 2 more
              (B); the 4 steps uninterrupted (C).  B must equal A bit for
              bit, or (if the card's steps are not deterministic) lie
              within A's spread against C; the line says which.
22. serve:hybrid — jamba-v0.1-52b at its published width, depth cut
              32 → 8 (one period: 7 Mamba + 1 attention layer, 4 MoE + 4
              SwiGLU FFNs, 13.30 B parameters), bf16, B 4 × 2048 prompt
              tokens + 32 generated, through ``serve_model`` (what
              ``serve`` drives) with the launch counts set to 0 just
              before and read just after: K4's bf16 route launched once
              (the one attention layer's prefill), nothing else, 0 host
              syncs in the decode loop, tokens inside the vocabulary;
              then the same prefill through K4 and through its plain
              version within SERVE_TOL, the plain one taking the K4
              one's MoE routes (a near tie between two experts otherwise
              moves a token, and its logits by up to 1.7), the MoE's
              drops at capacity factor 1.25 (at least one), and the
              prefill's device time
              split into the Mamba scan, the MoE's routing, dispatch,
              expert matmuls and combine, K4 and the rest.
23. serve:rwkv — ``serve("rwkv6-3b", 4, 2048, 32)`` at the published
              config, whole (32 layers, 3.27 B parameters), bf16: no
              kernel launched (no attention), 0 decode syncs, tokens
              inside the vocabulary; the prefill's device time split into
              the WKV chunks, the channel mix and the rest.
24. lm:parity — the card against the CPU at float32 (LM_PARITY): jamba's
              smoke width at 16 layers and capacity factor 1.25,
              mixtral's smoke width, rwkv6-3b's published width at 2
              layers; T 256, the prefill and 4 decode steps fed the CPU's
              tokens: logits and every cache within 1e-4, every MoE route
              (expert, token, slot, kept or dropped) equal, K4's float32
              route once per attention layer.
25–27. train:rwkv, train:moe, train:hybrid — training through the new
              layer kinds at full width (TRAIN_KINDS), bf16, remat
              "full", 2 steps (3 until PR 26) through
              ``launch.train.train_model`` on ``make_local_mesh`` (what
              ``launch.train.train`` drives, with the config from
              ``dataclasses.replace``: the sharded step on DTensors, the
              MoE's constrainers and the Mamba and RWKV mixers'
              ``local_map`` regions) with the launch counts set to 0 just
              before and read just after: rwkv6-3b at 16 of 32 layers
              (2 × 1024 tokens, 1 microbatch); mixtral-8x7b at 2 of 32
              layers (4 × 4096, 4 microbatches); jamba-v0.1-52b at one period
              with 2 of 16 experts (4 × 1024, 4 microbatches).  Checks:
              finite losses, the first within 1.0 of ln V, every matrix
              moved, no all-zero m, 0 host syncs inside every step
              (backward included), no kernel of the port launched (the
              training route attends through the blocked twin).  Then
              the same steps on the unsharded step (``mesh=None``).
              Prints both runs' step seconds (step 2) and their ratio,
              tokens/s, MFU, peak memory, the MoE's dropped assignments,
              and one more unsharded step's device time split into the
              Mamba scan, the MoE's route, dispatch, experts and
              combine, the WKV chunks, the channel mix, the blocked
              attention, AdamW and the rest, with the idle share.
28. train:kinds-parity — the card against the CPU at float32
              (TRAIN_KINDS_PARITY): jamba's smoke width at 16 layers and
              capacity factor 1.25, mixtral's smoke width, rwkv6-3b's
              published width at 2 layers; B 2 × T 128, two
              ``train_step`` calls at microbatches 2: loss and grad
              norm, and per key the
              parameters, m and v (the largest relative Frobenius error
              of a tensor) within 1e-5, or within 2.5× the steps' own
              float32 error against the same steps in float64 where
              that is larger (the largest of three samples: the CPU's,
              and the CPU's and the card's at microbatches 1); every MoE
              route equal, drops on jamba.
29. shard:parity — the sharded builders (``train.steps.build_*_step``
              with a mesh) on a (1, 1) ``DeviceMesh`` over a world-1 NCCL
              group (``launch.train.make_local_mesh``, which starts it
              from a local store; the phase destroys it when done):
              granite-3-2b at full width, 2 layers, float32, two sharded
              train steps against the unsharded steps from one state on
              the same batches (loss, grad norm, every parameter, m and v
              within 1e-5 relative; 0 host syncs in a sharded step); then
              granite-3-8b at full width and depth, bf16, B 4 × 2048: the
              prefill through the sharded K4 route
              (``models.attention.flash_attention_sharded``: each rank's
              own heads, their KV expanded) equal to the unsharded K4
              prefill bit for bit, with the launch counts set to 0 just
              before each and read just after (K4's bf16 route once a
              layer on each), and both prefills' times.  The ``train``
              phase (20) and the kind phases (25–27) run
              ``launch.train.train_model`` through the local mesh, the
              same DTensor path, each beside the unsharded step at the
              same depth.
30. mesh:placement — the placement chain on the port's own sharded
              step, after shard:parity has destroyed its group: a fake
              process group of 512 ranks in this process; the dry-run's
              granite-3-2b train_4k cell on the multi mesh (2, 16, 16) at
              full width and depth (``launch.dryrun.run_cell``: traced at
              1 and 2 periods, extrapolated as its row is) and its
              collective record (every collective resolved by its ranks;
              an unresolved group fails the cell); the record's traffic
              graph (``device_comm_graph``); ``fleet_monitor(record, 512,
              pods=2, machine_model="tree", device="cuda")`` with the
              launch counts set to 0 just before and read just after
              (K1 and K2 must both launch); the order a permutation of
              512 whose J is at most the identity's; the same
              ``fleet_monitor`` on the CPU: the same order, or J within
              1e-6 relative (the line says which held); outside that
              launch window, K2 at the monitor's candidate pairs and K1
              at its incumbent, on the plan's padded tensors of this
              graph, held against their plain versions (K2 per pair
              within K · 2⁻²³ of Σ|w| · d_max, K1 within 1e-6
              relative); one quiet tick
              (``observe_hlo(record)``, ``tick()``) commits no remap; then
              decode_32k traced on ``make_production_mesh(devices=order)``
              and on the identity layout: equal records.  Prints the
              graph's edges and GiB a step, split into ICI and DCN by the
              mesh dims each collective spans, both Js, the trace, map
              and tick seconds and the launches; the group is destroyed.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel,
K4 one per route: route, source, the TPU kernel it replaces, launches on
its path — the main map for K1 and K2, the gain call for K3, the serve
call for K4's bf16 route and the float32 prefill check for its float32
route —
max |kernel − plain|, ms, plain_ms, bound_ms, bound_by, library_ms; K1's
and K2's ms is the device time per launch, and they add
``batch_launches``, their launches in the multilevel batch's
``map_many``, ``batch_ms``, the device time of one launch of 4
lanes, ``portfolio_launches``, their launches in the portfolio map, and
``shared_ms``, the device time of one launch of 8 lanes over one
graph, ``remap_launches``, their launches in the remap phase's
ticks, ``service_launches``, their launches in the service phase's
timed burst, and ``placement_launches``, their launches in the
mesh:placement phase's ``fleet_monitor``); before it a line with the
whole run's seconds and one with the card's name and power limit; the
last is ``{"ok": true,
"device": {...}}``.  Without a card, or outside a checkout, it exits
non-zero and prints no result.  ``--stop-after
build|kernels|lint|portfolio|remap|service`` runs the phases up to that one
(portfolio: through portfolio:cpu; remap: through remap:bench; service:
through placement) and stops, with neither line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# outside the tensor cores (K1 and K2's arithmetic is scalar fp32/int32),
# TF32 on the tensor cores (the least time for K3's 2n³ and K4's float32
# attention; their 3xTF32 split issues three times that) and bf16 on the
# tensor cores (the least time for K4's bf16 attention)
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
# lanes of the shared-graph kernel checks: PortfolioSpec()'s
PORTFOLIO_LANES = 8
# the portfolio:cpu cell (flat, the forms cells' torus at n = 1024): its
# lanes and rounds, and its sweep budget, cut from the spec's 64 so the
# CPU side's refinements stay near a minute
PORTFOLIO_CPU = {"lanes": 4, "rounds": 3, "max_sweeps": 16}
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
# the remap cell: the closed loop on the main cell from the main map's
# incumbent.  Windows 0..quiet-1 carry the base traffic with ±jitter
# noise; from window `quiet` on, the edges touching a seeded shift_frac
# of the vertices carry shift_factor× their weight (BENCH_remap.json's
# shift_factor and shift_frac; viem remap-watch's synthesis); before window
# straggler_window's tick a StragglerMonitor of `hosts` hosts (patience
# 2) attached to the loop flags host 1, so a REBALANCE goes through the
# gate.  alpha is bench_remap.py's EMA weight.  objective_rtol bounds K1's
# float32 objective against the host float64 one relative to J: the
# weights and products rounded to float32 (2⁻²⁴ each) and a blocked sum
# of depth ~log2(E) + 2 stay below 1e-6 at E = 11,520.
REMAP = {"windows": 10, "quiet": 4, "jitter": 0.01, "shift_factor": 8.0,
         "shift_frac": 0.125, "straggler_window": 8, "hosts": 4,
         "alpha": 0.7, "seed": 23, "objective_rtol": 1e-5}
# the remap:bench cell: benchmarks/bench_remap.py's full workload (its
# constants), the card held to the CPU within score_rtol on the scores,
# and its CPU result in BENCH_remap.json (the JAX package on a CPU, not a
# device number): objective recovery against a scratch remap, and the
# incremental remap's time over the scratch remap's
BENCH_REMAP = {"grid": (8, 8, 4), "torus": (16, 16), "jitter": 0.01,
               "shift_factor": 8.0, "shift_frac": 0.125, "quiet": 4,
               "hosts": 4, "score_rtol": 1e-6,
               "reference": (2.883720930232558, 0.07727720424146999)}

# the service cell: bench_port_serve's spec with the main cell's backend on
# the main machine, placement_service_config(); warm-up copies carry the
# weights ×warm_scale (bench_serve's single warm-up), a served result is
# held to the same Mapper's single map within rtol on jf (the permutation
# equal) and to the host float64 objective within objective_rtol (REMAP's
# float32 bound: the burst's graphs have E near 11,520), the same burst
# through a CPU service (max_wait_s cpu_max_wait_s, so the whole burst is
# queued before its first tick closes) gives the same permutations, and no
# wait on a result exceeds timeout seconds
SERVICE = {"warm_scale": 1.5, "rtol": 1e-6, "objective_rtol": 1e-5,
           "cpu_max_wait_s": 1.0, "timeout": 600}
# the service:bench cell: bench_serve's full workload, its repeats (6
# structures × 8 − 6) and its plan buckets, and BENCH_serve.json's
# throughput speedup (the JAX package on a CPU, not a device number)
BENCH_SERVE = {"repeats": 42, "speedup": 4.935614573322663,
               "buckets": ["K16:E1024:Pdyn", "K32:E2048:Pdyn",
                           "K8:E512:Pdyn"]}


def emit(obj) -> None:
    """One JSON line; a phase's carries ``t_s``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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
    from repro_torch.kernels.flash_attention import HEAD_DIMS
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
    f32 = ptxas_usage(reports["flash_attention"])
    for entry, use in f32.items():
        check(use.get("spill_stores", 0) == 0 and
              use.get("spill_loads", 0) == 0,
              f"build: K4's float32 entry {entry} spills: {use}")
    sass = sass_functions(library_path("flash_attention"))
    hgmma = sass_ops(sass, "flash_fwd_tf32", "HGMMA")
    check(any("TF32" in op for ops in hgmma.values() for op in ops),
          f"build: no tf32 HGMMA in the SASS of K4's float32 attention "
          f"entry (HGMMA by entry: {hgmma})")
    # q's small parts, the one register A operand of its tile loop, stay
    # in their registers round the loop in every head dim's entry
    clobbered = {f: clobbered_wgmma_operands(lines)
                 for f, lines in sass.items() if "flash_fwd_tf32" in f}
    check(len(clobbered) == len(HEAD_DIMS) and not any(clobbered.values()),
          f"build: K4's float32 tile loop overwrites the registers of q's "
          f"small parts: {({f: c[:4] for f, c in clobbered.items() if c})}")
    emit({"phase": "build", "seconds": secs,
          "libraries": [str(library_path(n).relative_to(ROOT))
                        for n in reports],
          "qap_objective": ptxas_usage(reports["qap_objective"]),
          "pair_gain": ptxas_usage(reports["pair_gain"]),
          "swap_gain": dict(ptxas_usage(reports["swap_gain"]),
                            gain_tile_dynamic_smem=swap_gain_smem()),
          "flash_attention_f32": f32,
          "flash_attention_f32_hgmma": hgmma,
          "flash_attention_f32_clobbered": {
              f: len(c) for f, c in clobbered.items()}})


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


def sass_functions(lib) -> dict:
    """{function: SASS lines} of the built library at path ``lib``, from
    ``cuobjdump -sass``; the names are the mangled ones."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"build: cuobjdump -sass failed for "
                               f"{lib}: {out.stderr.strip()[-2000:]}")
    funcs, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def sass_ops(funcs: dict, entry: str, opcode: str) -> dict:
    """{function: {instruction: count}} of the ``opcode`` instructions in
    ``funcs`` (:func:`sass_functions`), for every function whose name
    holds ``entry``."""
    import re
    from collections import Counter
    out = {}
    for f, lines in funcs.items():
        if entry not in f:
            continue
        ops = Counter(m.group(1) for line in lines
                      for m in [re.search(rf"\b({opcode}\S*)", line)] if m)
        out[f] = dict(ops)
    return out


# SASS: an instruction's address, opcode and operands (a guard dropped)
_SASS_INSN = (r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
              r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
# opcodes whose first register operand is read, not written
_SASS_NO_DEST = frozenset((
    "ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "BSSY", "BSYNC",
    "SYNCS", "MEMBAR", "WARPGROUP", "CALL", "RET", "EXIT", "UTMALDG",
    "UTMASTG", "UBLKCP", "CCTL", "FENCE", "NOP", "YIELD", "WARPSYNC",
    "ERRBAR", "DEPBAR"))


def _sass_written(op: str, args: list) -> set:
    """The general registers an instruction writes: its first register
    operand after any predicate outputs, widened by the opcode (.64,
    .WIDE: 2; .128: 4; HGMMA 64xNx8 F32: N/2)."""
    import re
    base = op.split(".")[0]
    if base in _SASS_NO_DEST or base.endswith("SETP"):
        return set()
    rest = list(args)
    while rest and re.fullmatch(r"!?U?P(T|R|\d+)", rest[0]):
        rest.pop(0)
    m = re.fullmatch(r"R(\d+)", rest[0]) if rest else None
    if m is None:
        return set()
    if base == "HGMMA":
        n = int(re.search(r"\.64x(\d+)x", op).group(1)) // 2
    elif re.search(r"\.128\b", op):
        n = 4
    elif re.search(r"\.(64|WIDE)\b", op) or (base == "CS2R" and
                                             ".32" not in op):
        n = 2
    else:
        n = 1
    return set(range(int(m.group(1)), int(m.group(1)) + n))


def clobbered_wgmma_operands(lines) -> list:
    """Register A operands of ``wgmma`` (RS-form HGMMA: 4 registers from
    the first after the accumulator) that a loop carries and yet
    overwrites: for each backward branch, an HGMMA in its body whose A
    registers no instruction of the body writes before it, but one
    writes after it.  Where the source never changes the operand in the
    loop (K4's float32 kernel: q's small parts), the next trip's HGMMA
    then reads a value that is not the operand's — the fault ptxas made
    of that kernel at hd 32 without its keep-alive read (``csrc/
    flash_attention.cu``).  A loop that writes the next trip's operand
    at the end of a trip, as K3's does (``swap_gain.cu``: ``split_a``
    after the wait), is flagged too: this check is for the former kind.
    Returns (HGMMA address, operand, writer address, writer opcode,
    registers hit) per write."""
    import re
    insns = []
    for line in lines:
        m = re.search(_SASS_INSN, line)
        if m:
            args = [a.strip() for a in m.group(3).split(",") if a.strip()]
            insns.append((int(m.group(1), 16), m.group(2), args))
    found = []
    for addr, op, args in insns:
        if op.split(".")[0] != "BRA" or not args or \
                not args[-1].startswith("0x") or int(args[-1], 16) >= addr:
            continue
        body = [x for x in insns if int(args[-1], 16) <= x[0] <= addr]
        for i, (at, o, g) in enumerate(body):
            if not o.startswith("HGMMA") or len(g) < 2 or \
                    not re.fullmatch(r"R\d+", g[1]):
                continue
            regs = set(range(int(g[1][1:]), int(g[1][1:]) + 4))
            if any(regs & _sass_written(o2, g2) for _, o2, g2 in body[:i]):
                continue                # set in the loop before its use
            for at2, o2, g2 in body[i + 1:]:
                hit = regs & _sass_written(o2, g2)
                if hit:
                    found.append((hex(at), g[1], hex(at2), o2,
                                  sorted(hit)))
    return found


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
    shared_graph(forms, k1, k2, g, dg, us, vs, eu, ev)
    emit({"phase": "kernels", "qap_objective": k1, "pair_gains": k2})
    return k1, k2


def shared_graph(forms, k1, k2, g, dg, us, vs, eu, ev):
    """K2 in the tree form and K1 at the main shape over ONE graph
    shared by PORTFOLIO_LANES lanes (the portfolio's restart lanes: the
    graph and pair tensors have lane stride 0, the permutations do not),
    seeded permutations a lane and real weights.  Each lane bit-equal to
    a single launch on its permutation and to the stacked launch of the
    same graph copied once a lane; the device time per launch beside the
    lanes' single launches and the stacked launch, and the bound (the
    shared tensors read once).  Adds ``shared_ms`` (and the rest under
    ``shared``) to ``k1`` and ``k2``."""
    import numpy as np
    import torch

    from repro_torch.kernels import pair_gains, qap_objective_edges
    dev = torch.device(DEVICE)
    b, n = PORTFOLIO_LANES, g.n
    rng = np.random.default_rng(29)
    kind, params, D = form_of(*forms["tree"], dev)
    perms = torch.from_numpy(np.stack([rng.permutation(n) for _ in range(b)])
                             .astype(np.int32)).to(dev)
    wgt = (dg.wgt * torch.from_numpy(
        rng.random(tuple(dg.wgt.shape)).astype(np.float32) * 3.0 + 0.5)
        .to(dev)).contiguous()
    e, p = int(eu.shape[0]), int(us.shape[0])
    ew = torch.from_numpy(rng.random(e).astype(np.float32) * 3.0).to(dev)
    ew[g.num_edges:] = 0.0                          # padding stays inert

    def lanes(x):
        return x[None].expand(b, *x.shape).contiguous()

    stacked = {"nbr": lanes(dg.nbr), "wgt": lanes(wgt), "us": lanes(us),
               "vs": lanes(vs), "eu": lanes(eu), "ev": lanes(ev),
               "ew": lanes(ew)}
    cases = {
        "pair_gains": (
            lambda: pair_gains(kind, params, dg.nbr, wgt, perms, us, vs, D),
            lambda: pair_gains(kind, params, stacked["nbr"], stacked["wgt"],
                               perms, stacked["us"], stacked["vs"], D),
            lambda i: pair_gains(kind, params, dg.nbr, wgt, perms[i], us, vs,
                                 D),
            # the shared tensors once, every lane's π and gains
            (nbytes(us, vs, dg.nbr, wgt, perms) + b * p * 4,
             b * p * 2.0 * dg.max_deg * 3.0), k2),
        "qap_objective": (
            lambda: qap_objective_edges(kind, params, eu, ev, ew, perms, D),
            lambda: qap_objective_edges(kind, params, stacked["eu"],
                                        stacked["ev"], stacked["ew"], perms,
                                        D),
            lambda i: qap_objective_edges(kind, params, eu, ev, ew, perms[i],
                                          D),
            (nbytes(eu, ev, ew, perms, D) + b * 4, b * e * 2.0), k1)}
    for name, (shared, stack, single, (n_bytes, ops), rec) in cases.items():
        got = shared()
        check(torch.equal(got, stack()),
              f"{name}: the shared-graph launch differs from the stacked one")
        for i in range(b):
            check(torch.equal(got[i], single(i)),
                  f"{name}: shared-graph lane {i} of {b} differs from its "
                  f"single launch")
        out = dict(device_ms(shared), lanes=b,
                   singles_device_ms=device_ms(
                       lambda: [single(i) for i in range(b)],
                       iters=ITERS // 4)["device_ms"],
                   stacked_device_ms=device_ms(stack)["device_ms"],
                   bit_equal_to_singles=True, bit_equal_to_stacked=True)
        out["bound_ms"], out["bound_by"] = bound(n_bytes, ops)
        out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
        rec["shared"] = out
        rec["shared_ms"] = out["device_ms"]
        emit({"phase": "kernels", "kernel": name, "shared_graph": out})
    del stacked


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


def pf_spec():
    """The portfolio cell's spec: the multilevel cell's (eco, 4 levels)
    with ``PortfolioSpec()``'s defaults (8 lanes, 4 rounds, tenure 8,
    kick 0.15, stagnation 3, don't-look bits)."""
    from repro_torch.core.spec import PortfolioSpec
    return ml_spec().replace(portfolio=PortfolioSpec())


def launches_between(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in MAP_KERNELS}


def instrument_portfolio(plan):
    """Wrap a portfolio plan's lane refinements (each level's
    ``refine_lanes``), its pyramid, its round loop and the kick it makes
    so a run records: each lane refinement's level, seconds (ending in a
    synchronize), K1/K2 launches and syncs; the pyramid's seconds; the
    launch counts at every kick and at the loop's end.  Returns (the
    record, a function that restores the plan)."""
    import torch

    from repro_torch.portfolio import search as pf_search
    rec = {"levels": [], "kick_marks": []}
    restore = []
    for lvl, eng in enumerate(plan.engines):
        orig = eng.refine_lanes

        def recording(g_, perms, pairs, _eng=eng, _orig=orig, _lvl=lvl,
                      **kw):
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(g_, perms, pairs, **kw)
            torch.cuda.synchronize()
            rec["levels"].append({
                "level": _lvl, "n": g_.n, "lanes": len(perms),
                "pairs": len(pairs), "seconds": time.perf_counter() - t0,
                "launches": launches_between(before, read_launches()),
                "syncs": dict(_eng.last_syncs),
                "swaps": [st.swaps for st in out],
                "jf": [st.final_objective for st in out]})
            return out
        eng.refine_lanes = recording
        restore.append(lambda _eng=eng, _orig=orig: setattr(
            _eng, "refine_lanes", _orig))
    orig_pyramid = plan._pyramid

    def timed_pyramid(g_, seed):
        t0 = time.perf_counter()
        out = orig_pyramid(g_, seed)
        rec["pyramid_seconds"] = time.perf_counter() - t0
        return out
    plan._pyramid = timed_pyramid
    restore.append(lambda: setattr(plan, "_pyramid", orig_pyramid))
    runner = plan.portfolio
    orig_rounds = runner.run_rounds

    def timed_rounds(*a, **kw):
        rec["rounds_start"] = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_rounds(*a, **kw)
        torch.cuda.synchronize()
        rec["rounds_seconds"] = time.perf_counter() - t0
        rec["rounds_end"] = read_launches()
        return out
    runner.run_rounds = timed_rounds
    restore.append(lambda: setattr(runner, "run_rounds", orig_rounds))
    orig_make = pf_search.make_kick

    def make_kick(n, frac):
        kick = orig_make(n, frac)

        def marked(*a):
            rec["kick_marks"].append(read_launches())
            return kick(*a)
        marked.klen = kick.klen
        return marked
    pf_search.make_kick = make_kick
    restore.append(lambda: setattr(pf_search, "make_kick", orig_make))

    def undo():
        for fn in restore:
            fn()
    return rec, undo


def phase_portfolio(topo, g):
    """``Mapper(..., pf_spec()).map(g)`` at the main cell's n on the main
    machine: 8 lanes constructed at n = 512, refined in one sweep loop a
    level over the shared graph, then the kick → refine → tournament
    rounds at n = 4096 (PortfolioSpec() defaults).  Checks a bijection,
    jf equal to the host float64 objective, K1 and K2 launched, and every
    observed sync a counted read (each level's lane refinement, each
    contraction, the round loop; none in the upload of the starts and
    draws).  Prints the construction, pyramid, lane-refinement and round
    seconds, each round's incumbent J, kick ms, K1/K2 launches and reads,
    and jf beside the multilevel map's under the same seed (lane 0 has
    its construction: the port's stand-in for the reference's
    portfolio-against-restarts bench)."""
    import torch

    from repro_torch.core import Mapper, qap_objective
    mapper = Mapper(topo, pf_spec(), device=DEVICE)
    plan = mapper.lower_for(g)
    runner = plan.portfolio
    rec, undo = instrument_portfolio(plan)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = mapper.map(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    undo()
    perm = res.perm
    check(sorted(perm.tolist()) == list(range(g.n)),
          "portfolio: result is not a bijection")
    jf_host = qap_objective(g, topo, perm)
    check(res.final_objective == jf_host,
          f"portfolio: jf {res.final_objective} != host {jf_host}")
    check_launched(launches, MAP_KERNELS, "portfolio")
    pyramid = plan._pyramid(g, plan.spec.seed)          # the cached one
    check(len(rec["levels"]) == len(pyramid),
          f"portfolio: {len(rec['levels'])} lane refinements for "
          f"{len(pyramid)} levels")
    for lv in rec["levels"]:
        check_counted(lv["syncs"], f"portfolio level {lv['level']}")
    for lvl in range(1, len(pyramid)):
        check_counted(pyramid[lvl].syncs,
                      f"portfolio contraction to level {lvl}")
    syncs = dict(runner.last_syncs)
    check_counted(syncs, "portfolio rounds")
    check(syncs["upload"] == 0,
          f"portfolio: the upload of starts and draws synced "
          f"{syncs['upload']} times")
    marks = rec["kick_marks"] + [rec["rounds_end"]]
    rounds = []
    for i, row in enumerate(runner.last_rounds):
        rounds.append(dict(row, launches=launches_between(marks[i],
                                                          marks[i + 1])))
    trace = res.search_stats.objective_trace
    ml_jf = ML_REFERENCE_LEVELS[-1][1]
    out = {"phase": "portfolio", "n": g.n,
           "spec": plan.describe()["portfolio"],
           "levels_built": len(pyramid),
           "j0": res.initial_objective, "jf": res.final_objective,
           "objective_trace": trace, "rounds_run": len(trace) - 1,
           "multilevel_jf": ml_jf, "jf_over_multilevel": res.final_objective
           / ml_jf,
           "construction_seconds": res.construction_seconds,
           "pyramid_seconds": rec.get("pyramid_seconds"),
           "search_seconds": res.search_seconds, "map_seconds": wall,
           "lane_refinements": [
               {k: v for k, v in lv.items() if k != "syncs"}
               | {"reads": lv["syncs"]["reads"],
                  "syncs_observed": lv["syncs"]["observed"],
                  "passes": lv["syncs"]["passes"]}
               for lv in rec["levels"]],
           "rounds_seconds": rec["rounds_seconds"],
           "rounds_launches": launches_between(rec["rounds_start"],
                                               rec["rounds_end"]),
           "rounds_reads": syncs["reads"],
           "rounds_syncs_observed": syncs["observed"],
           "upload_syncs_observed": syncs["upload"],
           "rounds": rounds, "launches": launches,
           "swaps": res.search_stats.swaps,
           "evaluated": res.search_stats.evaluated,
           "max_memory_allocated": peak}
    emit(out)
    return out


def phase_portfolio_cpu():
    """A portfolio map on the card held to the CPU (plain versions) bit
    for bit: flat, the forms cells' torus (16, 16, 4) at n = 1024, 4
    lanes, 3 rounds, with the sweep budget of PORTFOLIO_CPU (cut from
    64).  The CPU plan takes the card's lane constructions (host numpy,
    the same code on both sides) instead of constructing them again;
    the lane refinements, kicks and rounds run on each side.  Equal:
    permutation, j0, jf, objective trace, swaps and evaluated pairs;
    every observed sync of the card's run a counted read."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, grid3d
    from repro_torch.core.spec import PortfolioSpec
    from repro_torch.topology import TorusTopology
    side = SIZE["side"]
    topo = TorusTopology((side, side, side // 4))
    g = grid3d(side, side, side // 4)
    spec = MappingSpec(engine="device", backend="pallas",
                       max_sweeps=PORTFOLIO_CPU["max_sweeps"],
                       portfolio=PortfolioSpec(
                           lanes=PORTFOLIO_CPU["lanes"],
                           rounds=PORTFOLIO_CPU["rounds"]))
    card = Mapper(topo, spec, device=DEVICE).lower_for(g)
    runner = card.portfolio
    captured = {}
    orig = runner.construct_lanes

    def capture(*a, **kw):
        out = orig(*a, **kw)
        captured["perms"] = [p.copy() for p in out]
        return out
    runner.construct_lanes = capture
    reset_launches()
    t0 = time.perf_counter()
    res = card.execute(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    runner.construct_lanes = orig
    check_launched(launches, MAP_KERNELS, "portfolio:cpu")
    syncs = dict(runner.last_syncs)
    check_counted(syncs, "portfolio:cpu rounds")
    check_counted(card.engines[0].last_syncs, "portfolio:cpu lanes")
    check(syncs["upload"] == 0, "portfolio:cpu: the upload synced")
    cpu = Mapper(topo, spec, device="cpu").lower_for(g)
    cpu.portfolio.construct_lanes = lambda *a, **kw: [
        p.copy() for p in captured["perms"]]
    t1 = time.perf_counter()
    ref = cpu.execute(g)
    cpu_s = time.perf_counter() - t1
    a, b = ref.search_stats, res.search_stats
    check(np.array_equal(ref.perm, res.perm) and
          ref.initial_objective == res.initial_objective and
          ref.final_objective == res.final_objective and
          a.objective_trace == b.objective_trace and a.swaps == b.swaps and
          a.evaluated == b.evaluated,
          "portfolio:cpu: the card's portfolio differs from the CPU's")
    out = {"phase": "portfolio:cpu", "n": g.n, "lanes": spec.portfolio.lanes,
           "rounds": spec.portfolio.rounds,
           "max_sweeps": PORTFOLIO_CPU["max_sweeps"],
           "max_sweeps_cut_from": 64,
           "j0": res.initial_objective, "jf": res.final_objective,
           "objective_trace": b.objective_trace, "swaps": b.swaps,
           "construction_seconds": res.construction_seconds,
           "search_seconds": res.search_seconds, "map_seconds": wall,
           "cpu_search_seconds": cpu_s, "launches": launches,
           "rounds_reads": syncs["reads"],
           "rounds_syncs_observed": syncs["observed"],
           "kick_ms": [r["kick_ms"] for r in runner.last_rounds],
           "round_seconds": [r["seconds"] for r in runner.last_rounds],
           "cpu_kick_ms": [r["kick_ms"] for r in cpu.portfolio.last_rounds],
           "cpu_round_seconds": [r["seconds"]
                                 for r in cpu.portfolio.last_rounds],
           "equals_cpu": True}
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


# ------------------------------------------------------- phases remap
def _remap_windows(g, rng, quiet, total, jitter, factor, hot):
    """The observed traffic of ``total`` windows over ``g``: every window
    jittered by ±``jitter``; from window ``quiet`` on, the edges touching
    a ``hot`` vertex (a mask) carry ``factor``× their weight — ``viem
    remap-watch``'s synthesized windows."""
    import numpy as np

    from repro_torch.core import from_edges
    u, v, w = g.edge_list()
    touched = hot[u] | hot[v]
    wins = []
    for t in range(total):
        wt = w * rng.uniform(1 - jitter, 1 + jitter, len(w))
        if t >= quiet:
            wt = np.where(touched, wt * factor, wt)
        wins.append(from_edges(g.n, u, v, wt))
    return wins


class _RemapProbe:
    """Records what a monitor's warm remaps did: each ``execute_warm``
    call's inputs and result, its seconds on the card (ending in a
    synchronize), and (through :func:`instrument`) each engine call's
    launches and syncs."""

    def __init__(self, plan):
        import numpy as np
        import torch
        self.warm = []
        self.calls, self._undo = instrument(plan.engines)
        self._plan, self._orig = plan, plan.execute_warm

        def warm(live, perm, pairs=None, active=None, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self._orig(live, perm, pairs=pairs, active=active, **kw)
            torch.cuda.synchronize()
            self.warm.append({"perm": np.array(perm),
                              "pairs_len": len(pairs),
                              "active": np.array(active), "res": res,
                              "seconds": time.perf_counter() - t0})
            return res

        plan.execute_warm = warm

    def undo(self):
        self._undo()
        self._plan.execute_warm = self._orig


def _tick_row(r, n_pairs):
    state = ("remapped" if r.remapped else r.skipped or
             ("rejected" if r.verdict else
              ("armed" if r.drift.armed else "disarmed")))
    return {"window": r.window - 1, "decision": state,
            "forced_by": r.forced_by, "score": r.drift.score,
            "l1": r.drift.l1, "objective_delta": r.drift.objective_delta,
            "triggered": r.triggered, "remapped": r.remapped,
            "dirty": r.dirty, "active_pairs": r.active_pairs,
            "pairs": n_pairs, "retraces": r.retraces,
            "predicted_improvement": (None if r.verdict is None else
                                      r.verdict.predicted_improvement)}


def phase_remap(topo, g, perm):
    """The closed loop at the main cell (REMAP's note) from the main
    map's incumbent: one line per tick and a summary; checks every
    statement of REMAP's note."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, qap_objective
    from repro_torch.monitor import MonitorConfig, RemapMonitor
    from repro_torch.obs import get_tracer
    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.runtime.fault_tolerance import StragglerMonitor
    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(REMAP["seed"])
    hot = np.zeros(g.n, bool)
    hot[rng.permutation(g.n)[:int(REMAP["shift_frac"] * g.n)]] = True
    windows = _remap_windows(g, rng, REMAP["quiet"], REMAP["windows"],
                             REMAP["jitter"], REMAP["shift_factor"], hot)
    plan = Mapper(topo, MappingSpec(engine="device", backend="pallas"),
                  device=DEVICE).lower_for(g, schedule="pow2")
    objective_calls = [0, 0.0]
    orig_objective = plan.objective

    def counted_objective(g_, p_):
        # K1 with its upload and its one read (which waits for the card)
        t = time.perf_counter()
        out = orig_objective(g_, p_)
        objective_calls[0] += 1
        objective_calls[1] += time.perf_counter() - t
        return out

    # set before the monitor is built, so its detector and replay (which
    # keep plan.objective) and the warm remaps all go through it
    plan.objective = counted_objective
    committed = []
    t0 = time.perf_counter()
    mon = RemapMonitor(plan, g, perm=perm, config=MonitorConfig(
        min_weight=0.01, alpha=REMAP["alpha"]), seed=0,
        on_remap=lambda p, v: committed.append(p.copy()))
    setup_s = time.perf_counter() - t0
    n_pairs = len(mon.pairs)
    probe = _RemapProbe(plan)
    # the loop's own spans split each tick: monitor.window (the
    # profiler's fold), monitor.drift, monitor.remap, monitor.replay
    tracer = get_tracer()
    was_enabled = tracer.enabled
    tracer.enable()
    tracer.drain()
    rows = []
    reset_launches()
    t_phase = time.perf_counter()
    for t, win in enumerate(windows):
        if t == REMAP["straggler_window"]:
            sm = StragglerMonitor(n_hosts=REMAP["hosts"], patience=2)
            mon.attach(sm)
            for _ in range(3):
                sm.record_step({h: (3.0 if h == 1 else 1.0)
                                for h in range(REMAP["hosts"])})
        before = read_launches()
        n_warm, n_calls = len(probe.warm), len(probe.calls)
        n_obj, obj_s = objective_calls
        incumbent = mon.incumbent.copy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with host_boundary("monitor.tick", dev) as hb:
            mon.observe_graph(win)
            r = mon.tick()
        torch.cuda.synchronize()
        tick_s = time.perf_counter() - t1
        after = read_launches()
        row = _tick_row(r, n_pairs)
        split = {}
        for sp in tracer.drain():
            if sp.name.startswith("monitor.") and sp.name != "monitor.tick":
                split[sp.name] = split.get(sp.name, 0.0) + sp.dur
        row.update(tick_seconds=tick_s, split_seconds=split,
                   launches={k: after[k] - before[k] for k in MAP_KERNELS},
                   objective_calls=objective_calls[0] - n_obj,
                   objective_seconds=objective_calls[1] - obj_s,
                   syncs_outside_engine=hb.syncs)
        label = f"remap window {t}"
        if t < REMAP["quiet"]:
            check(not r.remapped and not r.triggered,
                  f"{label}: a quiet window triggered a remap")
        warm = probe.warm[n_warm:]
        calls = probe.calls[n_calls:]
        check(len(warm) == (1 if r.triggered and r.skipped is None else 0),
              f"{label}: {len(warm)} warm remaps for one tick")
        if warm:
            w = warm[0]
            remap_launches = {k: sum(c["launches"][k] for c in calls)
                              for k in MAP_KERNELS}
            check_launched(remap_launches, MAP_KERNELS, label)
            check(w["pairs_len"] == n_pairs and
                  all(len(c["pairs"][0]) == n_pairs for c in calls),
                  f"{label}: the refined pair array is not of length P")
            for c in calls:
                check_counted(c["syncs"], label)
            movable = np.zeros(g.n, bool)
            movable[mon.pairs[w["active"]].ravel()] = True
            check(np.array_equal(w["res"].perm[~movable],
                                 w["perm"][~movable]),
                  f"{label}: a vertex outside the active pairs moved")
            check(np.array_equal(w["perm"], incumbent),
                  f"{label}: the warm remap did not start at the incumbent")
            live = mon.profiler.live()
            j_inc = qap_objective(live, topo, incumbent)
            j_cand = qap_objective(live, topo, w["res"].perm)
            row.update(remap_seconds=w["seconds"],
                       remap_launches=remap_launches,
                       engine_reads=[c["syncs"]["reads"] for c in calls],
                       engine_syncs_observed=[c["syncs"]["observed"]
                                              for c in calls],
                       sweeps=sum(c["syncs"]["sweeps"] for c in calls),
                       moved=int(np.sum(w["res"].perm != w["perm"])),
                       actual_improvement=1.0 - j_cand / j_inc)
        if r.remapped:
            # the committed incumbent: a bijection whose K1 objective is
            # the host float64 one within float32 rounding
            p = mon.incumbent
            check(sorted(p.tolist()) == list(range(g.n)),
                  f"{label}: the committed incumbent is not a bijection")
            j32 = orig_objective(mon.baseline, p)
            j64 = qap_objective(mon.baseline, topo, p)
            check(abs(j32 - j64) <= REMAP["objective_rtol"] * j64,
                  f"{label}: plan.objective {j32} against host {j64}")
            row.update(committed_objective_k1=j32,
                       committed_objective_host=j64)
        rows.append(row)
        emit(dict(phase="remap", **row))
    phase_s = time.perf_counter() - t_phase
    launches = read_launches()
    if not was_enabled:
        tracer.disable()
    tracer.drain()
    probe.undo()
    plan.objective = orig_objective
    check(len(committed) == mon.remaps,
          f"remap: {len(committed)} commits reported, {mon.remaps} made")
    live = mon.baseline
    j32 = plan.objective(live, mon.incumbent)
    j64 = qap_objective(live, topo, mon.incumbent)
    check(abs(j32 - j64) <= REMAP["objective_rtol"] * j64,
          f"remap: plan.objective {j32} against host {j64}")
    info = plan.engines[0].cache_info()
    check(info["graph_entries"] <= plan.engines[0]._caps["graphs"],
          f"remap: the device-graph cache grew past its cap: {info}")
    out = {"phase": "remap", "n": g.n, "pairs": n_pairs,
           "windows": len(windows), "remaps": mon.remaps,
           "triggered": sum(r["triggered"] for r in rows),
           "quiet_remaps": sum(r["remapped"] for r in rows[:REMAP["quiet"]]),
           "hot_vertices": int(hot.sum()),
           "monitor_setup_seconds": setup_s, "ticks_seconds": phase_s,
           "remap_seconds": [r.get("remap_seconds") for r in rows],
           "remap_launches": {k: launches[k] for k in MAP_KERNELS},
           "final_objective_k1": j32, "final_objective_host": j64,
           "device_graph_cache": info, "checks_passed": True,
           "phase_seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def _bench_remap_run(device, time_scratch):
    """benchmarks/bench_remap.py's full workload through the port on
    ``device``: its three episodes, decisions and timings."""
    import numpy as np
    import torch

    from repro_torch.core import Mapper, MappingSpec, from_edges, grid3d
    from repro_torch.monitor import MonitorConfig, RemapMonitor
    from repro_torch.runtime.fault_tolerance import StragglerMonitor
    from repro_torch.topology import make_topology
    b = BENCH_REMAP
    g = grid3d(*b["grid"])
    topo = make_topology("torus", dims=list(b["torus"]))
    spec = MappingSpec(construction="hierarchytopdown",
                       neighborhood="communication", neighborhood_dist=10,
                       engine="device", seed=0)
    plan = Mapper(topo, spec, device=device).lower_for(g, schedule="pow2")
    mon = RemapMonitor(plan, g, config=MonitorConfig(min_weight=0.01,
                                                     alpha=0.7), seed=0)
    incumbent0 = mon.incumbent.copy()
    import repro_torch.monitor.loop as loop
    dirty, masks = [], []
    orig_mask = loop.dirty_pair_mask

    def mask(pairs, d):
        dirty.append(np.array(d))
        out = orig_mask(pairs, d)
        masks.append(np.array(out))
        return out
    loop.dirty_pair_mask = mask
    try:
        u, v, w = g.edge_list()
        rng = np.random.default_rng(0)

        def shift(base, verts):
            bu, bv, bw = base.edge_list()
            m = np.zeros(base.n, bool)
            m[verts] = True
            return from_edges(base.n, bu, bv, np.where(
                m[bu] & m[bv], bw * b["shift_factor"], bw))

        for _ in range(b["quiet"]):
            mon.observe_graph(from_edges(g.n, u, v, w * rng.uniform(
                1 - b["jitter"], 1 + b["jitter"], size=len(w))))
            mon.tick()
        quiet_remaps = mon.remaps
        frac = b["shift_frac"]
        true_shift = shift(g, np.arange(g.n // 8,
                                        g.n // 8 + int(frac * g.n)))
        shift_reports = []
        for _ in range(5):
            mon.observe_graph(true_shift)
            shift_reports.append(mon.tick())
        t_incr = sum(r.remap_seconds for r in shift_reports
                     if r.triggered and not r.skipped)
        j_old = plan.objective(true_shift, incumbent0)
        j_incr = plan.objective(true_shift, mon.incumbent)
        scratch = plan.execute(true_shift, seed=0)
        t_scratch = None
        if time_scratch:
            ts = []
            for _ in range(3):
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                plan.execute(true_shift, seed=0)
                if device == "cuda":
                    torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            t_scratch = float(np.median(ts))
        sm = StragglerMonitor(n_hosts=b["hosts"], patience=2)
        mon.attach(sm)
        for _ in range(3):
            sm.record_step({h: (3.0 if h == 1 else 1.0)
                            for h in range(b["hosts"])})
        evict_verts = np.arange(3 * g.n // 4, 3 * g.n // 4 + int(frac * g.n))
        pre_evict = mon.incumbent.copy()
        evict_reports = []
        for _ in range(3):
            mon.observe_graph(shift(mon.baseline, evict_verts))
            r = mon.tick()
            evict_reports.append(r)
            if r.remapped:
                break
    finally:
        loop.dirty_pair_mask = orig_mask
    return {"rows": [_tick_row(r, len(mon.pairs)) for r in mon.history],
            "reports": list(mon.history), "dirty": dirty, "masks": masks,
            "incumbent": mon.incumbent.copy(), "incumbent0": incumbent0,
            "remaps": mon.remaps, "quiet_remaps": quiet_remaps,
            "j_old": j_old, "j_incr": j_incr,
            "j_scratch": scratch.final_objective, "t_incr": t_incr,
            "t_scratch": t_scratch,
            "evict_forced": next((r.forced_by for r in evict_reports
                                  if r.forced_by), None),
            "evict_committed": any(r.remapped for r in evict_reports),
            "j_evict": (plan.objective(mon.baseline, pre_evict),
                        plan.objective(mon.baseline, mon.incumbent)),
            "pairs": len(mon.pairs), "commits": [
                r for r in shift_reports if r.remapped]}


def _rel_close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def phase_remap_bench():
    """benchmarks/bench_remap.py's full workload on the card and on the
    CPU (BENCH_REMAP's note)."""
    import numpy as np

    t_start = time.perf_counter()
    reset_launches()
    card = _bench_remap_run(DEVICE, time_scratch=True)
    launches = read_launches()
    check_launched(launches, MAP_KERNELS, "remap:bench")
    t0 = time.perf_counter()
    cpu = _bench_remap_run("cpu", time_scratch=False)
    cpu_s = time.perf_counter() - t0
    rel = BENCH_REMAP["score_rtol"]
    check(len(card["rows"]) == len(cpu["rows"]),
          "remap:bench: card and CPU ran different numbers of windows")
    for a, c in zip(card["rows"], cpu["rows"]):
        for key in ("decision", "forced_by", "triggered", "remapped",
                    "dirty", "active_pairs", "pairs"):
            check(a[key] == c[key], f"remap:bench window {a['window']}: "
                                    f"card {key} {a[key]} != CPU {c[key]}")
        for key in ("score", "l1", "objective_delta",
                    "predicted_improvement"):
            if a[key] is None or c[key] is None:
                check(a[key] is c[key], f"remap:bench: {key} missing")
                continue
            check(_rel_close(a[key], c[key], rel),
                  f"remap:bench window {a['window']}: card {key} "
                  f"{a[key]} against CPU {c[key]}")
    check(len(card["dirty"]) == len(cpu["dirty"]) and all(
        np.array_equal(x, y) for x, y in zip(card["dirty"], cpu["dirty"]))
        and all(np.array_equal(x, y)
                for x, y in zip(card["masks"], cpu["masks"])),
        "remap:bench: card and CPU dirty sets or active pairs differ")
    check(np.array_equal(card["incumbent0"], cpu["incumbent0"]) and
          np.array_equal(card["incumbent"], cpu["incumbent"]),
          "remap:bench: card and CPU committed permutations differ")
    for key in ("j_old", "j_incr", "j_scratch"):
        check(_rel_close(card[key], cpu[key], rel),
              f"remap:bench: card {key} {card[key]} against CPU {cpu[key]}")
    gap = max(card["j_old"] - card["j_scratch"], 1e-12)
    recovery = (card["j_old"] - card["j_incr"]) / gap
    ratio = card["t_incr"] / max(card["t_scratch"], 1e-12)
    check(card["quiet_remaps"] == 0, "remap:bench: a quiet window remapped")
    check(card["commits"], "remap:bench: the shift committed no remap")
    check(recovery >= 0.8, f"remap:bench: recovery {recovery} < 0.8 of the "
                           f"scratch remap's")
    check(ratio < 0.5, f"remap:bench: incremental time {ratio} of the "
                       f"scratch remap's, not < 0.5")
    first = card["commits"][0]
    out = {"phase": "remap:bench", "n": BENCH_REMAP["grid"][0] *
           BENCH_REMAP["grid"][1] * BENCH_REMAP["grid"][2],
           "pairs": card["pairs"], "windows": card["rows"],
           "quiet_remaps": card["quiet_remaps"], "remaps": card["remaps"],
           "trigger_window": first.window,
           "dirty_vertices": first.dirty, "active_pairs": first.active_pairs,
           "objective_incumbent": card["j_old"],
           "objective_incremental": card["j_incr"],
           "objective_scratch": card["j_scratch"],
           "objective_recovery": recovery,
           "objective_recovery_reference": BENCH_REMAP["reference"][0],
           "incremental_seconds": card["t_incr"],
           "scratch_seconds": card["t_scratch"], "time_ratio": ratio,
           "time_ratio_reference": BENCH_REMAP["reference"][1],
           "predicted_improvement": first.verdict.predicted_improvement,
           "actual_improvement": 1.0 - card["j_incr"] / card["j_old"],
           "evict_forced_by": card["evict_forced"],
           "evict_committed": card["evict_committed"],
           "evict_objective": card["j_evict"],
           "launches": {k: launches[k] for k in MAP_KERNELS},
           "cpu_seconds": cpu_s, "equals_cpu": True,
           "phase_seconds": time.perf_counter() - t_start}
    emit(out)
    return out


# ----------------------------------------------------- phases service
def _bench_serve():
    """``benchmarks/bench_port_serve.py``, the port's serving benchmark."""
    bench = str(ROOT / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import bench_port_serve
    return bench_port_serve


def service_spec():
    """``bench_port_serve._spec()`` (``bench_serve``'s: random
    construction, the communication neighborhood at d = 2, fast, the
    device engine, seed 0) with the main cell's backend."""
    return _bench_serve()._spec().replace(backend="pallas")


@contextlib.contextmanager
def _sweep_loops():
    """While entered, each engine sweep loop (``RefinementEngine._sweep``)
    from every thread, the service's worker among them: its lanes, n and
    syncs, appended to the yielded list."""
    from repro_torch.engine.sweep import RefinementEngine
    loops = []
    orig = RefinementEngine._sweep

    def sweep(eng, graphs, perms, *a, **kw):
        out = orig(eng, graphs, perms, *a, **kw)
        loops.append({"lanes": len(perms), "n": graphs[0].n,
                      "syncs": dict(eng.last_syncs)})
        return out

    RefinementEngine._sweep = sweep
    try:
        yield loops
    finally:
        RefinementEngine._sweep = orig


def _burst(svc, burst, timeout):
    """Submit every (graph, quality) of ``burst`` to ``svc`` at once, then
    wait for the answers: (tickets, {ticket: result}, {ticket: seconds
    from the first submission to its answer}, the burst's seconds)."""
    t0 = time.perf_counter()
    tickets = [svc.submit(g, quality=q) for g, q in burst]
    got, done = {}, {}
    while len(got) < len(tickets):
        t, res = svc.results.get(timeout=timeout)
        check(t not in got, f"service: ticket {t} answered twice")
        got[t] = res
        done[t] = time.perf_counter() - t0
    return tickets, got, done, time.perf_counter() - t0


def phase_service(topo):
    """``MappingService(Mapper(main machine, service_spec()),
    **placement_service_config())`` on the card: the batch cells' four
    graphs warmed once each on copies with weights ×1.5, then one timed
    burst — the four twice each, an n = 1024 graph (a size mismatch) and
    the first again as a "strong" request — with the launch counts set
    to 0 just before and read just after.  Checks one result per ticket;
    the mismatch a ValueError and the only error; a tick through
    ``execute_batch`` with K2 launched at ``max_batch`` lanes; hits plus
    deduped = the burst's repeats; every sync of every sweep and round
    loop a counted read; no tensor in a result; every served jf within
    SERVICE's objective_rtol of the host float64 objective.  Then, once
    the service has closed, each result is held to the same Mapper's
    single ``map`` on the card (the strong one with ``PortfolioSpec()``
    and the device engine: the permutation equal, jf within SERVICE's
    rtol) and to the plain versions at the service's own shapes: the
    same burst through a ``MappingService`` on a ``device="cpu"`` Mapper
    (its batch tick the same ``pow2`` lanes), the permutations equal."""
    import numpy as np

    from repro_torch.core import CommGraph, Mapper, grid3d, qap_objective
    from repro_torch.core.spec import PortfolioSpec
    from repro_torch.launch.serve import MappingService
    from repro_torch.launch.specs import placement_service_config
    from repro_torch.obs import get_tracer
    from repro_torch.testing import pair_gain_lanes, tensors_in
    t_start = time.perf_counter()
    side = SIZE["side"]
    spec = service_spec()
    graphs = batch_graphs(side, side, BATCH["radius"], BATCH["seed"])
    warm = [CommGraph(g.xadj.copy(), g.adjncy.copy(),
                      g.adjwgt * SERVICE["warm_scale"], g.vwgt.copy())
            for g in graphs]
    mismatch = grid3d(side, side, side // 4)
    burst = ([(g, None) for g in graphs + graphs]
             + [(mismatch, None), (graphs[0], "strong")])
    cfg = placement_service_config()
    mapper = Mapper(topo, spec, device=DEVICE)
    tracer = get_tracer()
    svc = MappingService(mapper, **cfg)
    try:
        t0 = time.perf_counter()
        for g in warm:
            svc.map(g, timeout=SERVICE["timeout"])
        warm_s = time.perf_counter() - t0
        svc.reset_stats()
        tracer.clear()
        tracer.enable()
        with _sweep_loops() as sweeps, pair_gain_lanes() as k2_lanes:
            reset_launches()
            tickets, got, done, wall = _burst(svc, burst,
                                              SERVICE["timeout"])
            launches = read_launches()
        spans = tracer.drain()
        stats = svc.stats()
    finally:
        tracer.disable()
        svc.close()
    check(sorted(got) == sorted(tickets), "service: not one result per "
                                          "ticket")
    mm_t, strong_t = tickets[-2], tickets[-1]
    check(isinstance(got[mm_t], ValueError),
          f"service: the size mismatch gave {got[mm_t]!r}")
    check(stats["errors"] == 1, f"service: {stats['errors']} errors")
    for t in tickets:
        check(t == mm_t or not isinstance(got[t], Exception),
              f"service: ticket {t} failed: {got[t]!r}")
        check(tensors_in(got[t]) == 0,
              f"service: ticket {t}'s result holds a tensor")
    check(stats["batches"] >= 1, "service: no tick took execute_batch")
    check(cfg["max_batch"] in k2_lanes,
          f"service: K2 never launched with {cfg['max_batch']} lanes "
          f"(lanes seen {sorted(set(k2_lanes))})")
    repeats = len(graphs)
    check(stats["result_cache_hits"] + stats["in_tick_deduped"] == repeats,
          f"service: hits {stats['result_cache_hits']} + deduped "
          f"{stats['in_tick_deduped']} != {repeats} repeats")
    check_launched(launches, MAP_KERNELS, "service")
    for sw in sweeps:
        check_counted(sw["syncs"], f"service sweep loop of {sw['lanes']} "
                                   f"lanes")
    # the strong request: its one round loop and the plan.execute around it
    rounds = [sp for sp in spans if sp.name == "portfolio.rounds"]
    check(len(rounds) == 1, f"service: {len(rounds)} round loops for the "
                            f"one strong request")
    rsp = rounds[0]
    strong = [sp for sp in spans if sp.name == "plan.execute"
              and sp.tid == rsp.tid and sp.t0 <= rsp.t0
              and rsp.t0 + rsp.dur <= sp.t0 + sp.dur]
    check(len(strong) == 1, "service: no plan.execute span holds the "
                            "strong request's rounds")
    round_syncs = rsp.attrs["syncs"]
    check_counted(round_syncs, "service portfolio rounds")
    check(round_syncs["upload"] == 0, "service: the portfolio upload synced")
    # the singles, on the main thread once the worker has stopped
    strong_spec = spec.replace(portfolio=PortfolioSpec(), engine="device")
    worst, worst_host, singles_s, rows = 0.0, 0.0, [], []
    singles = {}
    for t, (g, q) in zip(tickets, burst):
        if t == mm_t:
            continue
        sp = strong_spec if q == "strong" else None
        key = (id(g), q)
        if key not in singles:
            t1 = time.perf_counter()
            singles[key] = mapper.map(g, spec=sp)
            singles_s.append(time.perf_counter() - t1)
        one, res = singles[key], got[t]
        check(np.array_equal(res.perm, one.perm),
              f"service: ticket {t}'s permutation differs from its single "
              f"map")
        rel = abs(res.final_objective - one.final_objective) / max(
            abs(one.final_objective), 1e-30)
        worst = max(worst, rel)
        host_jf = qap_objective(g, topo, res.perm)
        rel_host = abs(res.final_objective - host_jf) / max(abs(host_jf),
                                                            1e-30)
        worst_host = max(worst_host, rel_host)
        check(rel_host <= SERVICE["objective_rtol"],
              f"service: ticket {t}'s jf {res.final_objective} is "
              f"{rel_host} relative from the host objective {host_jf}")
        rows.append({"ticket": t, "n": g.n, "quality": q or "default",
                     "jf": res.final_objective,
                     "single_jf": one.final_objective, "host_jf": host_jf,
                     "latency_s": done[t]})
    check(worst <= SERVICE["rtol"], f"service: jf {worst} relative from "
                                    f"the singles'")
    # the plain versions at the service's shapes: the burst again on the CPU
    cpu_cfg = dict(cfg, max_wait_s=SERVICE["cpu_max_wait_s"])
    with MappingService(Mapper(topo, spec, device="cpu"), **cpu_cfg) as cpu:
        cpu_tickets, cpu_got, _, cpu_s = _burst(cpu, burst,
                                                SERVICE["timeout"])
        cpu_stats = cpu.stats()
    check(cpu_stats["batches"] >= 1 and cpu_stats["errors"] == 1,
          f"service: the CPU burst ran {cpu_stats['batches']} batches "
          f"with {cpu_stats['errors']} errors")
    cpu_worst = 0.0
    for t, ct, (g, _) in zip(tickets, cpu_tickets, burst):
        res, ref = got[t], cpu_got[ct]
        if t == mm_t:
            check(isinstance(ref, ValueError),
                  f"service: the CPU's size mismatch gave {ref!r}")
            continue
        check(not isinstance(ref, Exception),
              f"service: the CPU's ticket {ct} failed: {ref!r}")
        check(np.array_equal(res.perm, ref.perm),
              f"service: ticket {t}'s permutation differs from the "
              f"CPU service's")
        host_jf = qap_objective(g, topo, ref.perm)
        rel = abs(ref.final_objective - host_jf) / max(abs(host_jf), 1e-30)
        cpu_worst = max(cpu_worst, rel)
        check(rel <= SERVICE["objective_rtol"],
              f"service: the CPU's ticket {ct} jf {ref.final_objective} "
              f"is {rel} relative from the host objective {host_jf}")
    ticks = [{"requests": sp.attrs.get("batch"), "seconds": sp.dur}
             for sp in spans if sp.name == "service.tick"]
    batches = [{"lanes": sp.attrs.get("batch"), "seconds": sp.dur}
               for sp in spans if sp.name == "plan.execute_batch"]
    out = {"phase": "service", "n": graphs[0].n, "spec": spec.to_dict(),
           "service_config": cfg, "requests": len(tickets),
           "warm_seconds": warm_s, "burst_seconds": wall,
           "burst_requests_per_s": len(tickets) / wall,
           "latency_p50_s": stats["latency_p50_s"],
           "latency_p99_s": stats["latency_p99_s"], "ticks": ticks,
           "execute_batch": batches,
           "k2_lanes": {str(k): k2_lanes.count(k)
                        for k in sorted(set(k2_lanes))},
           "launches": {k: launches[k] for k in MAP_KERNELS},
           "strong_seconds": strong[0].dur,
           "strong_latency_s": done[strong_t],
           "stats": {k: stats[k] for k in (
               "served", "batches", "batched_requests", "max_batch_seen",
               "result_cache_hits", "in_tick_deduped", "errors",
               "quality_served", "peak_queue_depth")},
           "sweep_loops": [{"lanes": sw["lanes"], "n": sw["n"],
                            "reads": sw["syncs"]["reads"],
                            "syncs_observed": sw["syncs"]["observed"]}
                           for sw in sweeps],
           "rounds_reads": round_syncs["reads"],
           "rounds_syncs_observed": round_syncs["observed"],
           "results": rows, "max_rel_jf_vs_single": worst,
           "max_rel_jf_vs_host": worst_host,
           "single_seconds": singles_s, "equals_singles": True,
           "cpu_burst_seconds": cpu_s,
           "cpu_stats": {k: cpu_stats[k] for k in (
               "batches", "batched_requests", "max_batch_seen",
               "result_cache_hits", "in_tick_deduped", "errors")},
           "cpu_max_rel_jf_vs_host": cpu_worst, "equals_cpu": True,
           "phase_seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def phase_service_bench():
    """``bench_port_serve.run`` with ``bench_serve``'s full workload on the
    card (BENCH_SERVE's note)."""
    t_start = time.perf_counter()
    rows = []
    payload = _bench_serve().run(
        lambda name, us, detail: rows.append([name, us, detail]),
        smoke=False, device=DEVICE)
    svc = payload["service"]
    check(svc["errors"] == 0, f"service:bench: {svc['errors']} requests "
                              f"failed")
    check(svc["result_cache_hits"] + svc["in_tick_deduped"]
          == BENCH_SERVE["repeats"],
          f"service:bench: hits {svc['result_cache_hits']} + deduped "
          f"{svc['in_tick_deduped']} != {BENCH_SERVE['repeats']}")
    check(svc["plan_buckets"] == BENCH_SERVE["buckets"],
          f"service:bench: buckets {svc['plan_buckets']} != "
          f"{BENCH_SERVE['buckets']}")
    check_launched(payload["baseline"]["kernel_launches"], MAP_KERNELS,
                   "service:bench baseline")
    emit({"phase": "service:bench", "payload": payload, "report": rows,
          "throughput_speedup": payload["headline"]["throughput_speedup"],
          "throughput_speedup_reference_cpu_jax": BENCH_SERVE["speedup"],
          "phase_seconds": time.perf_counter() - t_start})
    return payload


def phase_placement():
    """``placement_service()`` as a fleet scheduler starts it, in this
    process: its Mapper must resolve to the card, and it maps with
    ``placement_spec()``'s host engine, so it launches no kernel; the
    smoke's lines are held to the JAX package's on the CPU
    (``tests/test_torch_serve.py``)."""
    import torch

    from repro_torch.launch.serve import placement_service
    from repro_torch.launch.specs import placement_spec
    t_start = time.perf_counter()
    svc = placement_service()
    try:
        device, engine = svc.mapper.device, svc.mapper.spec.engine
    finally:
        svc.close()
    check(torch.device(device).type == "cuda",
          f"placement: placement_service() resolved to {device}")
    check(engine == placement_spec().engine,
          f"placement: engine {engine} is not placement_spec()'s")
    out = {"phase": "placement", "device": str(device), "engine": engine,
           "phase_seconds": time.perf_counter() - t_start}
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
# K4 at the serve phase's prefill shape (granite-3-8b, B 4 x T 2048) and
# at starcoder2-7b's sliding-window attention (T 8192, window 4096), bf16
# and float32 (the serve shape is the float32 check's); small cases at
# float32 and bf16: T ragged against the float32 route's 128-row q tiles
# (two 64-row warpgroups) and 32-key kv tiles and the bf16 route's 128-row
# tiles, T = 1, G = 1 with a window, MQA, and T = 64 (one bf16 kv tile per
# query row, so both sides round the same p).
# (b, t, h, kv, hd, window)
FLASH_SHAPES = {"serve": ((4, 2048, 32, 8, 128, 0), "bfloat16"),
                "window": ((1, 8192, 36, 4, 128, 4096), "bfloat16"),
                "serve-f32": ((4, 2048, 32, 8, 128, 0), "float32"),
                "window-f32": ((1, 8192, 36, 4, 128, 4096), "float32")}
FLASH_SMALL = {"ragged": (2, 333, 8, 2, 64, 0),
               "g1-window": (1, 200, 4, 4, 32, 48),
               "mqa": (2, 130, 8, 1, 128, 0),
               "one-tile": (4, 64, 32, 8, 128, 0),
               "one-tile-window": (2, 64, 8, 2, 96, 16),
               "t1": (2, 1, 8, 2, 128, 0),
               "t31": (2, 31, 8, 2, 64, 0),
               "t33": (2, 33, 6, 2, 96, 0),
               "t127": (2, 127, 8, 2, 128, 0),
               "t128": (2, 128, 8, 2, 128, 0),
               "t129": (2, 129, 6, 2, 96, 0),
               "t4500-window": (1, 4500, 8, 2, 128, 4096)}
FLASH_F32_TOL = 2e-5    # the same float32 terms summed in other orders
# the float32 route at the granite smoke prefill's shape, launched again
# and again in one process (b, t, h, kv, hd, window)
FLASH_REPEAT = {"shape": (2, 96, 4, 2, 32, 0), "launches": 256, "seed": 96}


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


def flash_repeat() -> dict:
    """FLASH_REPEAT's launches of K4's float32 route, each against the
    plain version on its own fresh inputs: the count beyond
    FLASH_F32_TOL must be 0."""
    import torch

    from repro_torch.kernels import FLASH_F32_KERNEL, flash_attention_kernel
    from repro_torch.kernels.ref import flash_attention_plain
    b, t, h, kv, hd, window = FLASH_REPEAT["shape"]
    n = FLASH_REPEAT["launches"]
    gen = torch.Generator(device=DEVICE).manual_seed(FLASH_REPEAT["seed"])
    before = FLASH_F32_KERNEL.launches
    errs = []
    for _ in range(n):
        q, k, v = (torch.randn((b, t, m, hd), generator=gen, device=DEVICE)
                   for m in (h, kv, kv))
        got = flash_attention_kernel(q, k, v, window=window)
        errs.append((got - flash_attention_plain(q, k, v, window=window))
                    .abs().amax())
    errs = torch.stack(errs)
    rec = {"phase": "flash", "case": "repeat", "shape": FLASH_REPEAT["shape"],
           "dtype": "float32", "launches": FLASH_F32_KERNEL.launches - before,
           "bad": int((errs > FLASH_F32_TOL).sum()),
           "max_abs_err": float(errs.max()), "tol": FLASH_F32_TOL}
    check(rec["launches"] == n, f"K4 repeat: {rec['launches']} float32 "
          f"launches, expected {n}")
    check(rec["bad"] == 0, f"K4 repeat: {rec['bad']} of {n} float32 "
          f"launches beyond {FLASH_F32_TOL} (max {rec['max_abs_err']})")
    return rec


def phase_lint():
    """``viem lint`` on the port must find nothing active, and its
    runtime audit on the card must pass every combo it runs."""
    from repro_torch.staticcheck import LintConfig, lint_paths
    from repro_torch.staticcheck.engine import DEFAULT_BASELINE
    from repro_torch.staticcheck.runtime_audit import run_audit
    t0 = time.perf_counter()
    result = lint_paths(LintConfig(baseline=DEFAULT_BASELINE), root=ROOT)
    lint_s = time.perf_counter() - t0
    check(not result.active and not result.unjustified,
          f"lint: {len(result.active)} active, {len(result.unjustified)} "
          f"unjustified: {[f.fingerprint() for f in result.active][:5]}")
    t0 = time.perf_counter()
    audit = run_audit(device=DEVICE)
    audit_s = time.perf_counter() - t0
    status = {}
    for e in audit["entries"]:
        status[e["status"]] = status.get(e["status"], 0) + 1
    failed = [e for e in audit["entries"] if e["status"] == "failed"]
    emit({"phase": "lint", "files": result.files_checked,
          "active": len(result.active), "suppressed": len(result.suppressed),
          "lint_seconds": lint_s, "audit_device": audit["device"],
          "audit": status, "audit_seconds": audit_s,
          "failed": [(e["construction"], e["topology"], e["problems"][:3])
                     for e in failed]})
    check(audit["ok"] and audit["device"] == DEVICE and status.get("ok"),
          f"lint: the runtime audit failed on {len(failed)} combos")


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
        # the bf16 tensor-core peak for bf16 and, for float32, at the TF32
        # tensor-core peak (one pass: the least any tensor-core scheme
        # takes); the float32 route's 3xTF32 split issues three passes,
        # and full float32 on the CUDA cores would run at their peak;
        # bytes: q, k, v read once, o written once
        flops = 4.0 * hd * visible_pairs(t, window) * b * h
        moved = nbytes(q, k, v) + nbytes(q)
        bound_ms, bound_by = bound(
            moved, flops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32)
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   gflop=flops / 1e9,
                   tflops_achieved=flops / (ms * 1e-3) / 1e12,
                   sdpa_max_abs_err=lib_err)
        if dtype == torch.float32:
            rec.update(bound_3xtf32_ms=bound(moved, 3.0 * flops,
                                             PEAK_TF32)[0],
                       bound_fp32_cores_ms=bound(moved, flops,
                                                 PEAK_FP32)[0])
            rec.update(share_of_3xtf32_bound=rec["bound_3xtf32_ms"] / ms,
                       share_of_fp32_cores_bound=rec["bound_fp32_cores_ms"]
                       / ms)
        records[name] = rec
        emit({"phase": "flash", "case": name, "shape": shape,
              "dtype": dname, **rec})
        del q, k, v, want, lib
        torch.cuda.empty_cache()
    emit(flash_repeat())
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


def prefill_pair(cfg, seed, batch, prompt_len, max_len, plans=None):
    """The prefill of ``cfg``'s seeded weights on the seeded prompts
    through K4, and again with K4's plain version in its place.  With
    ``plans`` (a list), the K4 prefill's MoE plans are recorded into it
    and the plain prefill takes them in place of routing its own tokens
    (``testing.moe_replay``), so that the comparison sees K4's arithmetic
    and not a token moved to another expert by a near tie.  Returns
    (logits, plain logits, K4 prefill seconds, plain seconds, params,
    prompts)."""
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    from repro_torch.testing import moe_replay, moe_routes
    params = init_params(seed, cfg, device=DEVICE)
    prompts = make_prompts(cfg, batch, prompt_len, seed, DEVICE)
    run = lambda: prefill_with_cache(params, prompts, cfg,  # noqa: E731
                                     max_len)[0]
    pin = plans is not None
    with torch.inference_mode():
        with moe_routes() if pin else contextlib.nullcontext() as got:
            logits, k4_s = _host_s(run)
        if pin:
            plans.extend(got)
        kernel = attention.flash_attention_kernel
        attention.flash_attention_kernel = flash_attention_plain
        try:
            with moe_replay(plans) if pin else contextlib.nullcontext():
                plain, plain_s = _host_s(run)
        finally:
            attention.flash_attention_kernel = kernel
    return logits, plain, k4_s, plain_s, params, prompts


def _group(kernel: str) -> str:
    """A device kernel's group by its name: K4 (flash_fwd_sm90, the bf16
    route, and flash_fwd, the float32 one), cuBLAS/CUTLASS matmuls, or
    other."""
    low = kernel.lower()
    if "flash_fwd" in low:
        return "K4 flash_fwd"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "sm90_", "sm80_", "ampere_")):
        return "matmul"
    return "other"


def device_split(fn, trace=False):
    """Profile one call of ``fn`` (ending in a synchronize) with
    torch.profiler: the kernels' device time by name (kernel events
    only, so a kernel is not counted again under the operator that
    launched it), grouped into K4, matmuls and the rest, the host-clock
    wall time of the profiled call, and the device's idle share of it.
    With ``trace``, the profiler records the card alone and the kernels
    are read from its exported Chrome trace: the profiler's own event
    tables take minutes over a train step's 10⁵ kernels.
    {"error": ...} if the profiler gives no device time on this
    machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if not trace:
        activities.insert(0, ProfilerActivity.CPU)
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _trace_rows(prof) if trace else _table_rows(prof)
    except (RuntimeError, AttributeError, OSError, ValueError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        return {"error": "the profiler recorded no device time"}
    groups = {"K4 flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        groups[_group(name)] += ms
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernel_launches": sum(c for _, _, c in rows),
            "groups_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, ms, c in top],
            "matmul_kernel_names": sorted({n[:60] for n, _, _ in rows
                                           if _group(n) == "matmul"})}


def _table_rows(prof) -> list:
    """(kernel name, device ms, launches) from the profiler's table."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def _trace_rows(prof) -> list:
    """(kernel name, device ms, launches) summed over the kernel events
    of the profiler's Chrome trace (durations in µs), written to and
    read from a scratch file under the checkout's ``build/``."""
    path = ROOT / "build" / "device_split.trace.json"
    path.parent.mkdir(exist_ok=True)
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    rows = {}
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("dur", 0) > 0:
            ms, n = rows.get(ev["name"], (0.0, 0))
            rows[ev["name"]] = (ms + ev["dur"] / 1e3, n + 1)
    return [(name, ms, n) for name, (ms, n) in rows.items()]


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


# ------------------------------------------------------------ phases 19–21
# the training path at granite-3-2b's full width: the train phase through
# launch.train's local mesh (the train_4k sequence length; 4
# microbatches, what default_microbatches gives on one card, passed
# explicitly as the reference's train() defaults to 1); 3 steps (4 until
# the train phases of the new layer kinds joined the run's time limit);
# depth 40 → 20 (PR 26: the run's time limit, once the sharded path's
# DTensor dispatch and shard:parity joined it)
TRAIN = {"arch": "granite-3-2b", "n_layers": 20, "steps": 3, "batch": 4,
         "seq": 4096, "microbatches": 4, "peak": PEAK_BF16}
# train:parity (float32) and train:checkpoint (bf16): full width, 2
# layers, batch 4 × 256 tokens in 2 microbatches, seeded weights and
# SyntheticLM batches; parity is the CPU tests' float32 measure (loss and
# grad norm relative, every parameter, m and v by relative Frobenius
# error per tensor)
TRAIN_SMALL = {"n_layers": 2, "batch": 4, "seq": 256, "microbatches": 2,
               "seed": 0, "tol": 1e-5}
# PR 25's granite-3-2b step seconds through the unsharded step at its
# full depth of 40 layers (runs 53–62 on an NVIDIA H100 80GB HBM3 at
# 700 W), printed under that name; the like-for-like figure is the train
# phase's own unsharded run at TRAIN's depth
TRAIN_PR25_STEP_S = (9.27, 9.95)
# shard:parity: the train half at TRAIN_SMALL's shape, the prefill half
# at the serve cell's model and prompt
SHARD = {"prefill_arch": "granite-3-8b", "batch": 4, "prompt_len": 2048,
         "seed": 0}


def _copy_state(state, device):
    """A copy of a train state on ``device`` (the parameters stay
    trainable)."""
    import copy
    return {"params": copy.deepcopy(state["params"]).to(device),
            "m": {k: t.to(device, copy=True) for k, t in state["m"].items()},
            "v": {k: t.to(device, copy=True) for k, t in state["v"].items()},
            "step": state["step"].to(device, copy=True)}


def _leaves(state):
    """(name, tensor) of every leaf of a train state, in one order."""
    out = [(f"params:{n}", p.detach())
           for n, p in state["params"].named_parameters()]
    for part in ("m", "v"):
        out += [(f"{part}:{n}", t) for n, t in sorted(state[part].items())]
    return out + [("step", state["step"])]


def _bits(t):
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _differing(a, b) -> list:
    """The names of the leaves where two train states differ in any bit."""
    import torch
    return [n for (n, x), (_, y) in zip(_leaves(a), _leaves(b))
            if not (x.shape == y.shape and
                    torch.equal(_bits(x), _bits(y.to(x.device))))]


def _rel_errors(got, want) -> dict:
    """Relative Frobenius error per leaf of ``got`` against ``want``
    (float64 on ``got``'s device)."""
    import torch
    out = {}
    for (n, x), (_, y) in zip(_leaves(got), _leaves(want)):
        if n == "step":
            continue
        x = x.double()
        y = y.to(x.device).double()
        out[n] = float(torch.linalg.vector_norm(x - y)
                       / torch.linalg.vector_norm(y))
    return out


def _train_batches(cfg, seq, batch, steps, seed, device):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import upload
    src = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    return [upload(src.batch_at(i), device) for i in range(steps)]


def _run_steps(state, batches, cfg, opt, microbatches, device) -> list:
    """``train_step`` over the batches, each inside a ``train.step``
    boundary (all threads: the backward runs on autograd's device
    thread); per step its loss, grad norm (one counted read after the
    step) and the syncs the boundary saw (None off CUDA)."""
    import torch

    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.train.steps import train_step
    out = []
    for b in batches:
        with host_boundary("train.step", device, all_threads=True) as hb:
            state, m = train_step(state, b, cfg, opt,
                                  microbatches=microbatches)
        with host_boundary("train.log", device) as hb_log:
            loss, gnorm = (float(x) for x in hb_log.read(
                torch.stack([m["loss"], m["grad_norm"]])))
        out.append({"loss": loss, "grad_norm": gnorm,
                    "step_syncs": hb.syncs, "log_syncs": hb_log.syncs,
                    "log_reads": hb_log.reads})
    return out


def check_step_syncs(log, label):
    """No host sync inside any train step (nor in a batch upload, where
    the log has one), and each step's log read's syncs all counted."""
    for i, r in enumerate(log):
        check(r["step_syncs"] == 0, f"{label}: step {i} made "
                                    f"{r['step_syncs']} host syncs inside "
                                    f"the train step")
        check(r.get("batch_syncs", 0) == 0,
              f"{label}: step {i}'s batch upload made "
              f"{r.get('batch_syncs')} host syncs")
        check(r["log_syncs"] == r["log_reads"] == 1,
              f"{label}: step {i}'s log read saw {r['log_syncs']} syncs "
              f"against {r['log_reads']} counted reads")


def phase_train_parity():
    """granite-3-2b at full width, 2 layers, float32: two train steps on
    the card and on the CPU from one initial state on the same batches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state
    p = TRAIN_SMALL
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), dtype="float32",
                              n_layers=p["n_layers"])
    opt = OptConfig()
    cpu_dev = torch.device("cpu")
    cpu = init_train_state(p["seed"], cfg, device=cpu_dev)
    card = _copy_state(cpu, DEVICE)
    batches = _train_batches(cfg, p["seq"], p["batch"], 2, p["seed"],
                             cpu_dev)
    reset_launches()
    t0 = time.perf_counter()
    card_log = _run_steps(card, [{k: x.to(DEVICE) for k, x in b.items()}
                                 for b in batches], cfg, opt,
                          p["microbatches"], torch.device(DEVICE))
    card_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    cpu_log = _run_steps(cpu, batches, cfg, opt, p["microbatches"], cpu_dev)
    cpu_s = time.perf_counter() - t0
    check(launches["flash_attention"] == 0 and
          launches["flash_attention_f32"] == 0,
          f"train:parity: the training route launched K4: {launches}")
    check_step_syncs(card_log, "train:parity")
    worst = {}
    for key in ("loss", "grad_norm"):
        worst[key] = max(abs(c[key] / w[key] - 1)
                         for c, w in zip(card_log, cpu_log))
        check(worst[key] <= p["tol"], f"train:parity: {key} card "
              f"{[c[key] for c in card_log]} vs CPU "
              f"{[w[key] for w in cpu_log]} beyond {p['tol']} relative")
    errs = _rel_errors(card, cpu)
    check(int(card["step"]) == int(cpu["step"]) == 2,
          "train:parity: step is not 2 on both")
    for part in ("params", "m", "v"):
        name, err = max(((n, e) for n, e in errs.items()
                         if n.startswith(part + ":")), key=lambda x: x[1])
        worst[part] = err
        check(err <= p["tol"], f"train:parity: {name} card vs CPU relative "
                               f"Frobenius error {err} beyond {p['tol']}")
    emit({"phase": "train:parity", "arch": TRAIN["arch"],
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "params": cfg.param_count(), "batch": p["batch"],
          "seq": p["seq"], "microbatches": p["microbatches"],
          "card_losses": [r["loss"] for r in card_log],
          "cpu_losses": [r["loss"] for r in cpu_log],
          "card_grad_norms": [r["grad_norm"] for r in card_log],
          "worst_rel": worst, "tol": p["tol"],
          "card_step_syncs": [r["step_syncs"] for r in card_log],
          "launches": launches, "card_s": card_s, "cpu_s": cpu_s,
          "phase_s": time.perf_counter() - t_phase})
    del cpu, card
    torch.cuda.empty_cache()


def train_split(cfg, state, batch, opt, microbatches):
    """The device time of one train step (torch.profiler: busy, idle share,
    kernel launches, matmul kernels by name), split into the blocked
    attention, AdamW, the other matmuls and the rest.  The attention's
    and AdamW's kernels share their names with others, so each is
    profiled alone at the step's shapes: one layer's attention as the
    step runs it per microbatch (two forwards under ``remat="full"`` —
    one in the forward, one recomputed — and one backward), times layers
    × microbatches, and one AdamW update with zero gradients; their
    matmul kernels are taken out of the step's matmul group."""
    import torch

    from repro_torch.models.attention import blocked_flash_attention
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.steps import train_step
    step = device_split(lambda: train_step(state, batch, cfg, opt,
                                           microbatches=microbatches),
                        trace=True)
    b = batch["tokens"].shape[0] // microbatches
    t = batch["tokens"].shape[1]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    q, k, v = (torch.randn((b, t, n, cfg.head_dim_), generator=gen,
                           device=DEVICE, dtype=cfg.torch_dtype)
               .requires_grad_()
               for n in (cfg.n_heads_eff, cfg.n_kv_heads, cfg.n_kv_heads))
    cot = torch.randn(q.shape, generator=gen, device=DEVICE,
                      dtype=cfg.torch_dtype)

    def attention():
        with torch.no_grad():
            blocked_flash_attention(q, k, v, cfg)
        out = blocked_flash_attention(q, k, v, cfg)
        torch.autograd.grad(out, (q, k, v), cot)

    attention()                                     # warm
    attn = device_split(attention, trace=True)
    del q, k, v, cot
    zeros = {n: torch.zeros_like(m) for n, m in state["m"].items()}
    adamw = device_split(lambda: adamw_update(state["params"], zeros, state,
                                              opt), trace=True)
    del zeros
    torch.cuda.empty_cache()
    if any("error" in r for r in (step, attn, adamw)):
        return {"step": step, "attention_layer": attn, "adamw": adamw}
    calls = cfg.n_layers * microbatches
    attention_ms = attn["device_busy_ms"] * calls
    matmul_ms = step["groups_ms"]["matmul"] - \
        attn["groups_ms"]["matmul"] * calls - adamw["groups_ms"]["matmul"]
    adamw_ms = adamw["device_busy_ms"]
    return {"step_busy_ms": step["device_busy_ms"],
            "step_wall_ms": step["wall_ms"],
            "device_idle_share": step["device_idle_share"],
            "kernel_launches": step["kernel_launches"],
            "split_ms": {"blocked_attention": attention_ms,
                         "matmul": matmul_ms, "adamw": adamw_ms,
                         "rest": step["device_busy_ms"] - attention_ms
                         - matmul_ms - adamw_ms},
            "attention_layer_ms": attn["device_busy_ms"],
            "attention_layer_launches": attn["kernel_launches"],
            "attention_layer_matmul_ms": attn["groups_ms"]["matmul"],
            "adamw_launches": adamw["kernel_launches"],
            "top_kernels": step["top_kernels"],
            "matmul_kernel_names": step["matmul_kernel_names"]}


def unsharded_steps(cfg, p, label):
    """``train_model`` with ``mesh=None`` (the one-card step without
    placements) for the same steps, batch and microbatches as the
    phase's run on the local mesh: (its log, its state)."""
    from repro_torch.launch.train import train_model
    out = train_model(cfg, p.get("steps", TRAIN_KINDS_STEPS), p["batch"],
                      p["seq"], microbatches=p["microbatches"],
                      device=DEVICE, mesh=None)
    check_step_syncs(out["log"], f"{label} (unsharded)")
    return out["log"], out["state"]


def phase_train():
    """``launch.train``'s loop (``train_model`` on ``make_local_mesh``, as
    ``train`` runs it) at granite-3-2b's full width and TRAIN's depth,
    bf16, with the launch counts set to 0 just before and read just
    after; then the same loop on the unsharded step (``mesh=None``) at
    the same depth, beside it (the 1-rank DTensor path's cost), and one
    more unsharded step profiled (``train_split``)."""
    import dataclasses
    import math
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_local_mesh, train_model, upload
    from repro_torch.train.steps import gather_train_state
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.train import OptConfig
    p = TRAIN
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(p["arch"]), n_layers=p["n_layers"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    started = not dist.is_initialized()
    mesh = make_local_mesh(DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = train_model(cfg, p["steps"], p["batch"], p["seq"],
                          microbatches=p["microbatches"], device=DEVICE,
                          mesh=mesh)
        gather_train_state(out["state"])
    finally:
        if started:
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log, state = out["log"], out["state"]
    check(launches["flash_attention"] == 0 and
          launches["flash_attention_f32"] == 0,
          f"train: the training route launched K4: {launches}")
    check(len(log) == p["steps"] and int(state["step"]) == p["steps"],
          f"train: {len(log)} steps logged, step {int(state['step'])}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in log), f"train: a non-finite loss or grad norm: {log}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(log[0]["loss"] - ln_v) <= 1.0,
          f"train: first loss {log[0]['loss']} not within 1.0 of ln V = "
          f"{ln_v}")
    check_step_syncs(log, "train")
    # m nonzero in every tensor; every matrix (projections, embeddings)
    # moved from its seeded start (the norm scales need not: an update of
    # lr ≈ 3e-4 is under half a bf16 spacing at 1.0)
    start = init_params(0, cfg, device=DEVICE)
    named = dict(state["params"].named_parameters())
    mats = [n for n, p0 in start.named_parameters() if p0.dim() >= 2]
    moved = torch.stack([torch.any(named[n].detach() != p0)
                         for n, p0 in start.named_parameters()
                         if p0.dim() >= 2]).cpu()
    m_nonzero = torch.stack([torch.any(t != 0)
                             for t in state["m"].values()]).cpu()
    del start
    check(bool(moved.all()), f"train: matrices that did not move: "
          f"{[n for n, ok in zip(mats, moved.tolist()) if not ok]}")
    check(bool(m_nonzero.all()), "train: an all-zero m tensor")
    times = [r["seconds"] for r in log]
    step_s = statistics.median(times[1:])
    tokens = p["batch"] * p["seq"]
    flops = cfg.model_flops_per_token("train") * tokens
    del out, state, named
    torch.cuda.empty_cache()
    plain_log, state = unsharded_steps(cfg, p, "train")
    plain_times = [r["seconds"] for r in plain_log]
    plain_s = statistics.median(plain_times[1:])
    # one more step, profiled (its own batch: the pipeline's next)
    opt = OptConfig(total_steps=p["steps"],
                    warmup_steps=max(1, p["steps"] // 10))
    batch = upload(SyntheticLM(cfg.vocab_size, p["seq"], p["batch"])
                   .batch_at(p["steps"]), torch.device(DEVICE))
    t_split = time.perf_counter()
    split = train_split(cfg, state, batch, opt, p["microbatches"])
    split_s = time.perf_counter() - t_split
    emit({"phase": "train", "arch": p["arch"], "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
          "params": cfg.param_count(), "batch": p["batch"],
          "seq": p["seq"], "microbatches": p["microbatches"],
          "losses": [r["loss"] for r in log],
          "grad_norms": [r["grad_norm"] for r in log],
          "lrs": [r["lr"] for r in log], "step_s": times,
          "median_step_s_2_to_3": step_s, "tokens_per_s": tokens / step_s,
          "mesh": "local (1, 1), world-1 NCCL group",
          "unsharded_step_s": plain_times,
          "unsharded_median_step_s_2_to_3": plain_s,
          "mesh_over_unsharded": step_s / plain_s,
          "pr25_unsharded_step_s_at_40_layers": TRAIN_PR25_STEP_S,
          "mfu": flops / step_s / p["peak"],
          "model_flops_per_step": flops,
          "max_memory_allocated": peak, "train_call_s": wall,
          "step_syncs": [r["step_syncs"] for r in log],
          "launches": launches,
          "device_split_one_unsharded_step": split,
          "split_s": split_s, "phase_s": time.perf_counter() - t_phase})
    del state, batch
    torch.cuda.empty_cache()


def phase_train_checkpoint():
    """The train:parity shape in bf16: 2 steps, ``save_async`` (in the
    JAX package's tree, ``convert.reference_tree``), 2 more (A); a fresh
    state restored from step 2 and 2 more (B); the same 4 steps
    uninterrupted (C), for the card's spread."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.convert import reference_tree
    from repro_torch.launch.train import MESH_SHAPE
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state
    p = TRAIN_SMALL
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=p["n_layers"])
    opt = OptConfig(total_steps=4, warmup_steps=1)
    batches = _train_batches(cfg, p["seq"], p["batch"], 4, p["seed"], dev)
    mb = p["microbatches"]
    ckpt_dir = ROOT / "build" / "train_checkpoint"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        mgr = CheckpointManager(ckpt_dir, keep=1)
        a = init_train_state(p["seed"], cfg, device=dev)
        a_log = _run_steps(a, batches[:2], cfg, opt, mb, dev)
        saved = _copy_state(a, dev)
        t0 = time.perf_counter()
        mgr.save_async(2, reference_tree(a), mesh_shape=MESH_SHAPE)
        snapshot_s = time.perf_counter() - t0
        a_log += _run_steps(a, batches[2:], cfg, opt, mb, dev)
        mgr.wait()
        b = init_train_state(p["seed"] + 1, cfg, device=dev)
        t0 = time.perf_counter()
        mgr.restore(mgr.latest_step(), reference_tree(b))
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    differ = _differing(b, saved)
    check(not differ, f"train:checkpoint: the restored state differs from "
                      f"the saved one at {differ[:4]}")
    del saved
    b_log = _run_steps(b, batches[2:], cfg, opt, mb, dev)
    c = init_train_state(p["seed"], cfg, device=dev)
    c_log = _run_steps(c, batches, cfg, opt, mb, dev)
    for label, log in (("A", a_log), ("B", b_log), ("C", c_log)):
        check_step_syncs(log, f"train:checkpoint run {label}")
    a_losses = [r["loss"] for r in a_log]
    b_losses = [r["loss"] for r in b_log]
    c_losses = [r["loss"] for r in c_log]
    ab, ac = _differing(b, a), _differing(c, a)
    if not ab and b_losses == a_losses[2:]:
        mode = "bit for bit"
    else:
        # the card's own spread: two uninterrupted runs
        mode = "within the spread of two uninterrupted runs"
        spread, diff = _rel_errors(c, a), _rel_errors(b, a)
        worst = {n: (diff[n], spread[n]) for n in diff
                 if diff[n] > spread[n]}
        check(not worst, f"train:checkpoint: resumed run beyond the spread "
                         f"of two uninterrupted runs at {list(worst)[:4]}")
        check(all(abs(x - y) <= abs(z - y) for x, y, z in
                  zip(b_losses, a_losses[2:], c_losses[2:])),
              f"train:checkpoint: resumed losses {b_losses} vs {a_losses} "
              f"beyond the spread of {c_losses}")
    emit({"phase": "train:checkpoint", "arch": TRAIN["arch"],
          "n_layers": cfg.n_layers, "dtype": cfg.dtype,
          "restored_bit_for_bit": True, "resumed": mode,
          "a_losses": a_losses, "b_losses": b_losses, "c_losses": c_losses,
          "a_b_leaves_differing": len(ab), "a_c_leaves_differing": len(ac),
          "snapshot_s": snapshot_s, "restore_s": restore_s,
          "phase_s": time.perf_counter() - t_phase})
    del a, b, c, batches
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 22–24
# serve:hybrid — jamba-v0.1-52b at its published width (d 4096, 32/8
# heads of 128, d_ff 14336, d_inner 8192, d_state 16, 16 experts top-2,
# vocab 65,536), depth cut 32 → 8: one period, 7 Mamba layers and 1
# attention layer, 4 MoE and 4 SwiGLU FFNs, 13.30 B parameters (26.6 GB
# in bf16; the whole model's 51.6 B, 103 GB, do not fit on one card);
# bf16, B 4 × 2048 prompt tokens + 32 generated, seeded random weights.
# At T 2048 the production capacity factor 1.25 gives 320 slots an
# expert against a mean load of 256, so the MoE drops tokens.
HYBRID = {"arch": "jamba-v0.1-52b", "n_layers": 8, "batch": 4,
          "prompt_len": 2048, "gen": 32, "seed": 0}
# serve:rwkv — rwkv6-3b whole (32 layers, d 2560, 40 heads of 64, d_ff
# 8960, vocab 65,536; 3.27 B parameters, 6.5 GB in bf16), the same batch
RWKV_SERVE = {"arch": "rwkv6-3b", "batch": 4, "prompt_len": 2048,
              "gen": 32, "seed": 0}
# lm:parity — the card against the CPU at float32: the prefill and
# `steps` decode steps (both fed the CPU's greedy tokens), logits and
# every cache within tol (the CPU tests' float32 tolerance against the
# JAX package), every MoE route (expert, token, slot, kept) equal.
# (arch, smoke config or the published one, overrides, batch): jamba's
# smoke width at 2 periods (period index 1 exercised) with the
# production capacity factor; mixtral's smoke width (split 4, window 64);
# rwkv6-3b at its published width, 2 layers.  The last `run` tokens of
# each prompt repeat one token (a padding or whitespace run): on uniform
# prompts the random router spreads jamba's tokens within capacity (the
# fullest expert at 160 of 160 slots on the CPU), and the run skews its
# load so that tokens drop at factor 1.25
LM_PARITY = {"cases": (("jamba-v0.1-52b", True,
                        {"n_layers": 16, "capacity_factor": 1.25}, 2),
                       ("mixtral-8x7b", True, {}, 2),
                       ("rwkv6-3b", False, {"n_layers": 2}, 2)),
             "t": 256, "run": 64, "steps": 4, "tol": 1e-4, "seed": 0}


def _rms1(gen, shape, dtype):
    """Seeded N(0, 1) rows scaled to RMS 1 (what a layer's ``rms_norm``
    with scale 1 hands on), on the card."""
    import torch
    x = torch.randn(shape, generator=gen, device=DEVICE)
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True))).to(dtype)


def _device_busy(fn, warm=True):
    """(ms, source, profile) of one call of ``fn`` after a warm one (none
    without ``warm``): its
    device busy ms from torch.profiler's kernel events
    (``device_split``), or, where the profiler records no device time,
    the CUDA-event ms of back-to-back calls (``cuda_ms``: the card's idle
    gaps counted too).  CUDA events around calls held behind a spin
    kernel (``device_ms``) do not serve here: a part of ~1,500 launches
    fills the stream's queue while it is held."""
    if warm:
        fn()
    rec = device_split(fn, trace=True)
    if "error" not in rec:
        return rec["device_busy_ms"], "torch.profiler", rec
    return (cuda_ms(fn, iters=3, warmup=1),
            f"CUDA events, idle gaps included ({rec['error']})", rec)


def prefill_split(run, parts: dict, warm=True) -> dict:
    """The device busy time of one prefill (``run``; after a warm call
    with ``warm``) split into ``parts`` ({name: (fn, count)}: each fn one
    layer's part at the prefill's shapes, counted once per layer of its
    kind) and the rest, each time from ``_device_busy``."""
    busy, source, whole = _device_busy(run, warm)
    info = {"busy_from": source}
    if "error" not in whole:
        info.update(prefill_wall_ms=whole["wall_ms"],
                    device_idle_share=whole["device_idle_share"],
                    kernel_launches=whole["kernel_launches"],
                    matmul_ms=whole["groups_ms"]["matmul"],
                    top_kernels=whole["top_kernels"])
    per_call, sources = {}, {}
    for name, (fn, _) in parts.items():
        per_call[name], sources[name], _ = _device_busy(fn)
    split = {name: per_call[name] * n for name, (_, n) in parts.items()}
    split["rest"] = busy - sum(split.values())
    return dict(info, prefill_busy_ms=busy, split_ms=split,
                per_layer_ms=per_call, per_layer_from=sources)


def _serve_line(label, cfg, out, wall, peak, launches):
    import torch
    tokens = out["tokens"].cpu()
    check(tuple(tokens.shape) == (out["tokens"].shape[0], out["gen"]) and
          tokens.dtype == torch.int32, f"{label}: tokens {tokens.shape} "
                                       f"{tokens.dtype}")
    check(0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size,
          f"{label}: a token outside the vocabulary")
    check(out["decode_syncs"] == 0,
          f"{label}: {out['decode_syncs']} host syncs in the decode loop")
    gen = out["gen"]
    return {"phase": label, "arch": cfg.name, "n_layers": cfg.n_layers,
            "batch": out["tokens"].shape[0], "prompt_len": out["prompt_len"],
            "gen": gen, "params": cfg.param_count(), "dtype": cfg.dtype,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_step_ms": out["decode_s"] / (gen - 1) * 1e3,
            "decode_tok_per_s": out["decode_tok_per_s"],
            "decode_syncs": out["decode_syncs"], "serve_call_s": wall,
            "max_memory_allocated": peak, "launches": launches,
            "sample": tokens[0, :8].tolist()}


def _serve_timed(serve_fn, first, p):
    """``serve_fn(first, batch, prompt_len, gen, ...)`` (``serve`` of an
    arch or ``serve_model`` of a config) with the launch counts set to 0
    just before and read just after, and the peak memory of the call."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = serve_fn(first, p["batch"], p["prompt_len"], p["gen"],
                   seed=p["seed"], device=DEVICE)
    wall = time.perf_counter() - t0
    launches = read_launches()
    out.update(gen=p["gen"], prompt_len=p["prompt_len"])
    return out, wall, torch.cuda.max_memory_allocated(), launches


def phase_serve_hybrid():
    """jamba-v0.1-52b at full width, one period, through ``serve_model``
    (what ``serve`` drives, with the config from ``dataclasses.replace``);
    then the same prefill through K4 and through its plain version, the
    MoE's drops, and the prefill's device time split."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_model
    p = HYBRID
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(p["arch"]), n_layers=p["n_layers"])
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn = sum(m == "attn" for m, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    out, wall, peak, launches = _serve_timed(serve_model, cfg, p)
    line = _serve_line("serve:hybrid", cfg, out, wall, peak, launches)
    check(launches["flash_attention"] == n_attn,
          f"serve:hybrid: K4 (bf16) launched {launches['flash_attention']} "
          f"times, expected {n_attn} (once per attention layer of the "
          f"prefill)")
    check(all(n == 0 for k, n in launches.items() if k != "flash_attention"),
          f"serve:hybrid: other kernels launched: {launches}")
    line["kinds"] = {f"{m}+{f}": kinds.count((m, f)) for m, f in set(kinds)}
    line["cut"] = (f"depth {get_config(p['arch']).n_layers} -> "
                   f"{cfg.n_layers} (one period); widths as published")
    tokens = out["tokens"].cpu()
    del out
    torch.cuda.empty_cache()

    max_len = p["prompt_len"] + p["gen"]
    routes = []
    logits, plain, k4_s, plain_s, params, prompts = prefill_pair(
        cfg, p["seed"], p["batch"], p["prompt_len"], max_len, plans=routes)
    check(len(routes) == n_moe, f"serve:hybrid: {len(routes)} MoE plans "
                                f"in a prefill of {n_moe} MoE layers")
    dropped = [int((~r[4]).sum()) for r in routes]
    slots = [int(r[4].numel()) for r in routes]
    del routes
    check(sum(dropped) > 0, "serve:hybrid: the MoE dropped no token at "
                            "capacity factor 1.25")
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          "serve:hybrid: non-finite prefill logits")
    diff = logits_diff(logits, plain, cfg.vocab_size)
    check(diff["rel_fro"] <= SERVE_TOL["rel_fro"] and
          diff["max_abs"] <= SERVE_TOL["max_abs"],
          f"serve:hybrid: K4 prefill vs plain prefill {diff} beyond "
          f"{SERVE_TOL}")
    last = logits[:, -1, :cfg.vocab_size].float()
    top2 = torch.topk(last, 2, dim=-1).values
    sure = ((top2[:, 0] - top2[:, 1]) > 0.1).cpu()
    first = last.argmax(-1).to(torch.int32).cpu()
    check(bool(torch.all((first == tokens[:, 0]) | ~sure)),
          "serve:hybrid: first generated token != argmax of the rebuilt "
          "prefill")
    del logits, plain, last
    torch.cuda.empty_cache()
    split = hybrid_split(cfg, params, prompts, max_len)
    del params, prompts
    torch.cuda.empty_cache()
    line.update(prefill_k4_vs_plain=diff, tol=SERVE_TOL,
                moe_dropped_per_layer=dropped, moe_assignments_per_layer=slots,
                prefill_warm_s=k4_s, prefill_plain_s=plain_s,
                prefill_split=split, phase_s=time.perf_counter() - t_phase)
    emit(line)


def hybrid_split(cfg, params, prompts, max_len):
    """The prefill's device time (``prefill_split``) split into the Mamba
    scan (``_chunked_ssm``), the MoE's routing, dispatch, expert matmuls
    and combine, K4 (the attention layer) and the rest.  Each part runs
    alone on one layer at the prefill's shapes (seeded inputs of RMS 1:
    the work is fixed by the shapes, the capacity included)."""
    import torch

    from repro_torch.models import mamba, moe
    import torch.nn.functional as F

    from repro_torch.models.attention import flash_attention
    from repro_torch.models.transformer import prefill_with_cache
    b, t = prompts.shape
    kinds = [layer.kind for layer in params.layers]
    n_mamba = sum(m == "mamba" for m, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    n_attn = sum(m == "attn" for m, _ in kinds)
    mam = next(layer for layer in params.layers if layer.kind[0] == "mamba")
    exp = next(layer for layer in params.layers if layer.kind[1] == "moe")
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dt = cfg.torch_dtype
    e, k = cfg.moe_experts, cfg.moe_top_k
    ev = exp.ffn["w1"].shape[0]
    cap = moe.capacity(cfg, t)
    with torch.inference_mode():
        xc = F.silu(_rms1(gen, (b, t, cfg.d_inner), dt))
        h0 = torch.zeros((b, cfg.d_inner, cfg.mamba_d_state),
                         dtype=torch.float32, device=DEVICE)
        x = _rms1(gen, (b, t, cfg.d_model), dt)
        se, st, sw, pos, keep, order, _ = moe._route(
            x, exp.ffn["router"], e, k, cap, ev // e)
        pos_c = torch.where(keep, pos, cap)
        buf = moe._dispatch(x, se, st, pos_c, ev, cap)
        y = moe._experts(exp.ffn, buf)
        hd = cfg.head_dim_
        q = torch.randn((b, t, cfg.n_heads_eff, hd), generator=gen,
                        device=DEVICE).to(dt)
        kv = torch.randn((b, t, cfg.n_kv_heads, hd), generator=gen,
                         device=DEVICE).to(dt)
        parts = {
            "mamba_scan": (lambda: mamba._chunked_ssm(
                mam.mixer, xc, xc @ mam.mixer["w_x"], cfg, h0), n_mamba),
            "moe_route": (lambda: moe._route(x, exp.ffn["router"], e, k,
                                             cap, ev // e), n_moe),
            "moe_dispatch": (lambda: moe._dispatch(x, se, st, pos_c, ev,
                                                   cap), n_moe),
            "moe_experts": (lambda: moe._experts(exp.ffn, buf), n_moe),
            "moe_combine": (lambda: moe._combine(y, se, sw, pos_c, order, t,
                                                 k * (ev // e)), n_moe),
            "attention_k4": (lambda: flash_attention(q, kv, kv, cfg),
                             n_attn)}
        return prefill_split(
            lambda: prefill_with_cache(params, prompts, cfg, max_len), parts)


def phase_serve_rwkv():
    """``serve("rwkv6-3b", ...)`` at the published config, whole: no
    kernel of the port is on this path; then the prefill's device time
    split into the WKV chunks, the channel mix and the rest."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import rwkv
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    p = RWKV_SERVE
    t_phase = time.perf_counter()
    cfg = get_config(p["arch"])
    out, wall, peak, launches = _serve_timed(serve, p["arch"], p)
    line = _serve_line("serve:rwkv", cfg, out, wall, peak, launches)
    check(all(n == 0 for n in launches.values()),
          f"serve:rwkv: a kernel was launched on a path without "
          f"attention: {launches}")
    del out
    torch.cuda.empty_cache()

    b, t, max_len = p["batch"], p["prompt_len"], p["prompt_len"] + p["gen"]
    with torch.inference_mode():
        params = init_params(p["seed"], cfg, device=DEVICE)
        prompts = make_prompts(cfg, b, t, p["seed"], DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        hd = cfg.rwkv_head_size
        shape = (b, t, cfg.d_model // hd, hd)
        r, k, v = (torch.randn(shape, generator=gen, device=DEVICE)
                   for _ in range(3))
        lw = torch.clamp(-torch.exp(torch.randn(shape, generator=gen,
                                                device=DEVICE)),
                         rwkv.LOG_W_MIN, rwkv.LOG_W_MAX)
        s0 = torch.zeros((b, cfg.d_model // hd, hd, hd), device=DEVICE)
        layer = params.layers[0]
        c = min(cfg.time_chunk, t)
        x = _rms1(gen, (b, t, cfg.d_model), cfg.torch_dtype)
        n = cfg.n_layers
        split = prefill_split(
            lambda: prefill_with_cache(params, prompts, cfg, max_len),
            {"wkv_chunks": (lambda: rwkv._wkv(r, k, v, lw, layer.mixer["u"],
                                              s0, c), n),
             "channel_mix": (lambda: rwkv.rwkv_channel_mix(layer.ffn, x),
                             n)})
        del r, k, v, lw, s0, x, params, prompts
    torch.cuda.empty_cache()
    line.update(prefill_split=split, phase_s=time.perf_counter() - t_phase)
    emit(line)


def _snapshot(caches):
    """The caches' tensors, copied to the CPU: {(layer, kind, name): t}."""
    return {(i, kind, name): t.detach().to("cpu", copy=True)
            for i, c in enumerate(caches) for kind, leaves in c.items()
            for name, t in leaves.items()}


def _lm_run(params, prompts, cfg, steps, tokens=None):
    """The prefill and ``steps`` greedy decode steps on ``params``'s
    device: logits and cache snapshots per step (on the CPU), the MoE
    plans, and the tokens fed (``tokens``, else each step's argmax)."""
    import torch

    from repro_torch.models.transformer import decode_step, prefill_with_cache
    from repro_torch.testing import moe_routes
    dev = prompts.device
    t = prompts.shape[1]
    logits_log, cache_log, fed = [], [], []
    with torch.inference_mode(), moe_routes() as routes:
        logits, caches = prefill_with_cache(params, prompts, cfg, t + steps)
        for i in range(steps + 1):
            logits_log.append(logits[:, -1].float().cpu())
            cache_log.append(_snapshot(caches))
            if i == steps:
                break
            tok = (tokens[i] if tokens is not None else
                   torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                   .cpu())
            fed.append(tok)
            logits, caches = decode_step(params, tok.to(dev), caches, t + i,
                                         cfg)
        plans = [tuple(a.cpu() for a in r[:5]) for r in routes]
    return logits_log, cache_log, plans, fed


def phase_lm_parity():
    """Each LM_PARITY case at float32 on the card and on the CPU from
    the same seeded weights and prompts: prefill logits and caches, then
    ``steps`` decode steps fed the CPU's tokens, every logit and cache
    within tol, every MoE plan equal."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import init_params
    p = LM_PARITY
    t_phase = time.perf_counter()
    cases = []
    for arch, smoke, over, b in p["cases"]:
        base = get_smoke_config(arch) if smoke else get_config(arch)
        cfg = dataclasses.replace(base, dtype="float32", **over)
        cpu = init_params(p["seed"], cfg, device="cpu")
        prompts = make_prompts(cfg, b, p["t"], p["seed"], "cpu")
        prompts[:, -p["run"]:] = prompts[:, :1]
        t0 = time.perf_counter()
        want = _lm_run(cpu, prompts, cfg, p["steps"])
        cpu_s = time.perf_counter() - t0
        card = cpu.to(DEVICE)
        reset_launches()
        t0 = time.perf_counter()
        got = _lm_run(card, prompts.to(DEVICE), cfg, p["steps"],
                      tokens=want[3])
        card_s = time.perf_counter() - t0
        launches = read_launches()
        del cpu, card
        label = f"lm:parity {arch}"
        n_attn = sum(cfg.layer_kind(i)[0] == "attn"
                     for i in range(cfg.n_layers))
        check(launches["flash_attention_f32"] == n_attn and
              launches["flash_attention"] == 0,
              f"{label}: K4 launches {launches}, expected {n_attn} of the "
              f"float32 route (one prefill)")
        logits_err = max(float((g - w).abs().max())
                         for g, w in zip(got[0], want[0]))
        cache_err = max(float((g[key].float() - w[key].float()).abs().max())
                        for g, w in zip(got[1], want[1]) for key in w)
        check(logits_err <= p["tol"] and cache_err <= p["tol"],
              f"{label}: card vs CPU logits {logits_err}, caches "
              f"{cache_err} beyond {p['tol']}")
        check(len(got[2]) == len(want[2]), f"{label}: {len(got[2])} MoE "
              f"plans on the card, {len(want[2])} on the CPU")
        routes_equal = all(torch.equal(g, w) for gp, wp in
                           zip(got[2], want[2])
                           for i, (g, w) in enumerate(zip(gp, wp))
                           if i != 2)                    # 2: the weights
        check(routes_equal, f"{label}: an MoE route differs between the "
                            f"card and the CPU")
        dropped = sum(int((~wp[4]).sum()) for wp in want[2])
        if cfg.moe_experts and cfg.capacity_factor < cfg.moe_experts:
            check(dropped > 0, f"{label}: no token dropped at capacity "
                               f"factor {cfg.capacity_factor}")
        cases.append({"arch": arch, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "batch": b, "t": p["t"],
                      "decode_steps": p["steps"],
                      "capacity_factor": cfg.capacity_factor,
                      "logits_max_abs": logits_err,
                      "caches_max_abs": cache_err,
                      "moe_plans": len(want[2]), "moe_dropped": dropped,
                      "launches": launches, "card_s": card_s,
                      "cpu_s": cpu_s})
    torch.cuda.empty_cache()
    emit({"phase": "lm:parity", "dtype": "float32", "tol": p["tol"],
          "cases": cases, "phase_s": time.perf_counter() - t_phase})


# ------------------------------------------------------------ phases 25–28
# training through the MoE, Mamba and RWKV kinds at full width: bf16,
# remat "full", random weights from seed 0, SyntheticLM seed 0 and
# OptConfig(total_steps=steps, warmup_steps=1) (launch.train's), 2
# steps (3 until PR 26) through launch.train.train_model.  State at 16 B
# a parameter (bf16 weight and gradient, float32 m, v and gradient sum):
#   train:rwkv   rwkv6-3b, 16 of its 32 layers since PR 26 (whole:
#                3.272 B parameters, ~52.3 GB); batch
#                cut 4 × 2048 in 2 microbatches → 2 × 1024 in 1 for the
#                whole run's time limit: its step is host dispatch
#                (~340k launches a microbatch at T 2048, in proportion
#                to T, whatever the rows; on an NVIDIA H100 80GB HBM3
#                at 700 W, 19.4 s a step at 4 × 2048 in 2, 11.65 s at
#                2 × 2048 in 1);
#   train:moe    mixtral-8x7b at its published width (d 4096, 8 experts
#                of d_ff 14336, top-2, capacity factor 1.25, window
#                4096), depth 32 → 2 (its period is 1): 3.165 B (~50.6 GB);
#   train:hybrid jamba-v0.1-52b at its published width, one period (7
#                Mamba + 1 attention, 4 MoE + 4 SwiGLU), experts 16 → 2:
#                3.430 B (~54.9 GB).  One period with 16 experts is
#                13.295 B parameters (~213 GB of state), with 4 it is
#                4.839 B (~77 GB); with 2 experts and top-2 every token
#                goes to both experts and nothing drops (train:moe and
#                train:kinds-parity carry the routing and the drops).
TRAIN_KINDS = {
    "train:rwkv": {"arch": "rwkv6-3b", "over": {"n_layers": 16},
                   "batch": 2, "seq": 1024, "microbatches": 1,
                   "cut": {"batch": "4 x 2048 in 2 microbatches -> "
                                    "2 x 1024 in 1",
                           "n_layers": "32 -> 16 (PR 26)"}},
    "train:moe": {"arch": "mixtral-8x7b", "over": {"n_layers": 2},
                  "batch": 4, "seq": 4096, "microbatches": 4},
    "train:hybrid": {"arch": "jamba-v0.1-52b",
                     "over": {"n_layers": 8, "moe_experts": 2},
                     "batch": 4, "seq": 1024, "microbatches": 4}}
TRAIN_KINDS_STEPS = 2          # 3 until PR 26 (the run's time limit)
# train:kinds-parity — float32, the card against the CPU from one seeded
# state: jamba's smoke width at 16 layers and capacity factor 1.25,
# mixtral's smoke width, rwkv6-3b's published width at 2 layers (the
# CPU side's time and ~15 GB); B 2 × T 128 (256 until the run's time
# limit took it), 2 microbatches, 2 steps,
# OptConfig().  On the MoE configs the last `run` tokens of each row
# repeat its first (as LM_PARITY's prompts do), so that jamba's MoE
# drops assignments.  The truth is the same steps in float64 on the CPU
# (testing.float64_evaluation, held to the JAX package's float64 steps
# within 1e-10 by tests/test_torch_train_kinds.py).  Per key (loss, grad
# norm, and each parameter, m and v) the card's error against it within
# tol (TRAIN_SMALL's) or, where larger, `spread` times the CPU's own
# float32 spread on that key (the largest of its runs' errors at
# microbatches 2 and 1 and their distance from each other; a tensor's
# error differs up to 2.3× between those two runs): the factored WKV
# chunk's gradients and AdamW's first steps on
# zero-initialised tensors (Mamba conv_b, RWKV w0 and ln_b) are
# ill-conditioned in float32, the JAX package's own steps included
TRAIN_KINDS_PARITY = {
    "cases": (("jamba-v0.1-52b", True,
               {"n_layers": 16, "capacity_factor": 1.25}),
              ("mixtral-8x7b", True, {}),
              ("rwkv6-3b", False, {"n_layers": 2})),
    "batch": 2, "t": 128, "run": 32, "steps": 2, "microbatches": 2,
    "seed": 0, "tol": 1e-5, "spread": 2.5}


def _fwd_bwd(fn, inputs):
    """A part as a train step under remat "full" runs it: a forward
    without grad (the forward pass), one with grad (the recomputation)
    and its backward, with ones as the outputs' cotangents."""
    import torch

    def run():
        with torch.no_grad():
            fn()
        outs = [o for o in fn() if o.requires_grad]
        torch.autograd.grad(outs, inputs,
                            [torch.ones_like(o) for o in outs],
                            allow_unused=True)
    return run


def train_kinds_split(cfg, state, batch, opt, microbatches):
    """One more train step's device time (``prefill_split`` of the step)
    split into the parts of its layer kinds, each run alone on one layer
    at a microbatch's shapes as the step runs it (``_fwd_bwd``: forward,
    recomputation, backward; seeded inputs of RMS 1), counted once per
    layer of its kind and microbatch: the Mamba scan (``_chunked_ssm``),
    the MoE's route, dispatch, experts and combine, the WKV chunks
    (``_wkv``), the channel mix, the blocked attention, and AdamW (once,
    zero gradients); the rest is the step's busy time less the parts."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import mamba, moe, rwkv
    from repro_torch.models.attention import blocked_flash_attention
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.steps import train_step
    b = batch["tokens"].shape[0] // microbatches
    t = batch["tokens"].shape[1]
    layers = list(state["params"].layers)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dt = cfg.torch_dtype

    def first(pred):
        return next((x for x in layers if pred(x.kind)), None)

    def count(pred):
        return sum(pred(x.kind) for x in layers) * microbatches

    def leaf(shape, dtype=dt):
        return _rms1(gen, shape, dtype).requires_grad_()

    parts = {}
    mam = first(lambda k: k[0] == "mamba")
    if mam is not None:
        xc = F.silu(leaf((b, t, cfg.d_inner))).detach().requires_grad_()
        h0 = torch.zeros((b, cfg.d_inner, cfg.mamba_d_state),
                         dtype=torch.float32, device=DEVICE)
        used = [mam.mixer[n] for n in ("w_x", "w_dt", "b_dt", "a_log")]
        parts["mamba_scan"] = (_fwd_bwd(
            lambda: mamba._chunked_ssm(mam.mixer, xc, xc @ mam.mixer["w_x"],
                                       cfg, h0)[:1],
            [xc] + used), count(lambda k: k[0] == "mamba"))
    exp = first(lambda k: k[1] == "moe")
    if exp is not None:
        e, k = cfg.moe_experts, cfg.moe_top_k
        ev = exp.ffn["w1"].shape[0]
        cap = moe.capacity(cfg, t)
        x = leaf((b, t, cfg.d_model))
        router = exp.ffn["router"]
        with torch.no_grad():
            se, st, sw, pos, keep, order, _ = moe._route(x, router, e, k,
                                                         cap, ev // e)
            pos_c = torch.where(keep, pos, cap)
            buf = moe._dispatch(x, se, st, pos_c, ev, cap)
            y = moe._experts(exp.ffn, buf)
        buf, y, sw = (a.detach().requires_grad_() for a in (buf, y, sw))
        weights = [exp.ffn[n] for n in ("w1", "w2", "w3")]
        n_moe = count(lambda k: k[1] == "moe")
        parts.update({
            "moe_route": (_fwd_bwd(
                lambda: moe._route(x, router, e, k, cap, ev // e)[2::4],
                [x, router]), n_moe),
            "moe_dispatch": (_fwd_bwd(
                lambda: [moe._dispatch(x, se, st, pos_c, ev, cap)], [x]),
                n_moe),
            "moe_experts": (_fwd_bwd(lambda: [moe._experts(exp.ffn, buf)],
                                     [buf] + weights), n_moe),
            "moe_combine": (_fwd_bwd(
                lambda: [moe._combine(y, se, sw, pos_c, order, t,
                                      k * (ev // e))], [y, sw]), n_moe)})
    tm = first(lambda k: k[0] == "rwkv")
    if tm is not None:
        hd = cfg.rwkv_head_size
        shape = (b, t, cfg.d_model // hd, hd)
        r, kk, v = (leaf(shape, torch.float32) for _ in range(3))
        with torch.no_grad():
            lw = torch.clamp(-torch.exp(torch.randn(
                shape, generator=gen, device=DEVICE)), rwkv.LOG_W_MIN,
                rwkv.LOG_W_MAX)
        lw.requires_grad_()
        s0 = torch.zeros((b, cfg.d_model // hd, hd, hd), device=DEVICE)
        c = min(cfg.time_chunk, t)
        u = tm.mixer["u"]
        parts["wkv_chunks"] = (_fwd_bwd(
            lambda: rwkv._wkv(r, kk, v, lw, u, s0, c), [r, kk, v, lw, u]),
            count(lambda k: k[0] == "rwkv"))
    cm = first(lambda k: k[1] == "channelmix")
    if cm is not None:
        x_cm = leaf((b, t, cfg.d_model))
        parts["channel_mix"] = (_fwd_bwd(
            lambda: rwkv.rwkv_channel_mix(cm.ffn, x_cm)[:1],
            [x_cm] + list(cm.ffn.values())),
            count(lambda k: k[1] == "channelmix"))
    if first(lambda k: k[0] == "attn") is not None:
        q, kv1, kv2 = (leaf((b, t, n, cfg.head_dim_)) for n in (
            cfg.n_heads_eff, cfg.n_kv_heads, cfg.n_kv_heads))
        parts["blocked_attention"] = (_fwd_bwd(
            lambda: [blocked_flash_attention(q, kv1, kv2, cfg)],
            [q, kv1, kv2]), count(lambda k: k[0] == "attn"))
    zeros = {n: torch.zeros_like(m) for n, m in state["m"].items()}
    parts["adamw"] = (lambda: adamw_update(state["params"], zeros, state,
                                           opt), 1)
    # the step itself is warm: the phase has run it
    split = prefill_split(lambda: train_step(state, batch, cfg, opt,
                                             microbatches=microbatches),
                          parts, warm=False)
    del zeros
    torch.cuda.empty_cache()
    return {k.replace("prefill", "step"): v for k, v in split.items()}


def phase_train_kind(label):
    """One TRAIN_KINDS cell through ``launch.train.train_model`` on
    ``make_local_mesh``, as ``launch.train.train`` runs it (the launch
    counts set to 0 just before and read just after, the MoE's drops
    counted), its checks; then the same steps on the unsharded step
    (``mesh=None``) beside it, and one more unsharded step's split."""
    import dataclasses
    import math
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import make_local_mesh, train_model, upload
    from repro_torch.models.transformer import init_params
    from repro_torch.testing import moe_routes
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import gather_train_state
    p = TRAIN_KINDS[label]
    steps = TRAIN_KINDS_STEPS
    t_phase = time.perf_counter()
    full = get_config(p["arch"])
    cfg = dataclasses.replace(full, **p["over"])
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    started = not dist.is_initialized()
    mesh = make_local_mesh(DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with moe_routes() as routes:
            out = train_model(cfg, steps, p["batch"], p["seq"],
                              microbatches=p["microbatches"], device=DEVICE,
                              mesh=mesh)
        gather_train_state(out["state"])
    finally:
        if started:
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log, state = out["log"], out["state"]
    # every route of the run: the forward's and the recomputation's
    dropped = sum(int((~r[4]).sum()) for r in routes)
    assignments = sum(r[4].numel() for r in routes)
    n_routes = len(routes)
    del routes
    check(all(n == 0 for n in launches.values()),
          f"{label}: the training route launched a kernel: {launches}")
    check(len(log) == steps and int(state["step"]) == steps,
          f"{label}: {len(log)} steps logged, step {int(state['step'])}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in log), f"{label}: a non-finite loss or grad norm: "
                             f"{log}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(log[0]["loss"] - ln_v) <= 1.0,
          f"{label}: first loss {log[0]['loss']} not within 1.0 of ln V "
          f"= {ln_v}")
    check_step_syncs(log, label)
    start = init_params(0, cfg, device=DEVICE)
    named = dict(state["params"].named_parameters())
    mats = [n for n, p0 in start.named_parameters() if p0.dim() >= 2]
    moved = torch.stack([torch.any(named[n].detach() != p0)
                         for n, p0 in start.named_parameters()
                         if p0.dim() >= 2]).cpu()
    m_nonzero = torch.stack([torch.any(t != 0)
                             for t in state["m"].values()]).cpu()
    del start
    check(bool(moved.all()), f"{label}: matrices that did not move: "
          f"{[n for n, ok in zip(mats, moved.tolist()) if not ok]}")
    check(bool(m_nonzero.all()), f"{label}: an all-zero m tensor")
    times = [r["seconds"] for r in log]
    step_s = statistics.median(times[1:])
    tokens = p["batch"] * p["seq"]
    flops = cfg.model_flops_per_token("train") * tokens
    del out, state, named
    torch.cuda.empty_cache()
    plain_log, state = unsharded_steps(cfg, p, label)
    plain_times = [r["seconds"] for r in plain_log]
    plain_s = statistics.median(plain_times[1:])
    opt = OptConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    batch = upload(SyntheticLM(cfg.vocab_size, p["seq"], p["batch"])
                   .batch_at(steps), torch.device(DEVICE))
    t_split = time.perf_counter()
    split = train_kinds_split(cfg, state, batch, opt, p["microbatches"])
    split_s = time.perf_counter() - t_split
    emit({"phase": label, "arch": p["arch"], "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "moe_experts": cfg.moe_experts,
          "dtype": cfg.dtype, "remat": cfg.remat,
          "kinds": {f"{m}+{f}": kinds.count((m, f)) for m, f in
                    sorted(set(kinds))},
          "cut": dict({k: f"{getattr(full, k)} -> {v}"
                       for k, v in p["over"].items()}, **p.get("cut", {})),
          "params": cfg.param_count(),
          "active_params": cfg.active_param_count(),
          "batch": p["batch"], "seq": p["seq"],
          "microbatches": p["microbatches"],
          "losses": [r["loss"] for r in log],
          "grad_norms": [r["grad_norm"] for r in log],
          "lrs": [r["lr"] for r in log], "step_s": times,
          "median_step_s_after_first": step_s,
          "tokens_per_s": tokens / step_s,
          "mesh": "local (1, 1), world-1 NCCL group",
          "unsharded_step_s": plain_times,
          "unsharded_median_step_s_after_first": plain_s,
          "mesh_over_unsharded": step_s / plain_s,
          "mfu": flops / step_s / PEAK_BF16,
          "model_flops_per_step": flops,
          "max_memory_allocated": peak, "train_call_s": wall,
          "step_syncs": [r["step_syncs"] for r in log],
          "moe_dropped": dropped, "moe_assignments": assignments,
          "moe_route_calls": n_routes, "launches": launches,
          "device_split_one_unsharded_step": split, "split_s": split_s,
          "phase_s": time.perf_counter() - t_phase})
    del state, batch
    torch.cuda.empty_cache()


def _kinds_batches(cfg, p, device):
    """SyntheticLM batches (seed ``p["seed"]``), the last ``p["run"]``
    tokens of each row its first token on a MoE config."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import upload
    src = SyntheticLM(cfg.vocab_size, p["t"], p["batch"], seed=p["seed"])
    out = []
    for i in range(p["steps"]):
        b = src.batch_at(i)
        if cfg.moe_experts:
            b["tokens"][:, -p["run"]:] = b["tokens"][:, :1]
            b["labels"][:, -p["run"] - 1:-1] = b["tokens"][:, :1]
        out.append(upload(b, device))
    return out


def phase_train_kinds_parity():
    """Each TRAIN_KINDS_PARITY case at float32: two ``train_step`` calls
    on the card and on the CPU from one seeded state; the truth is the
    same steps in float64 on the CPU (``testing.float64_evaluation``,
    which the CPU tests hold to the JAX package's float64 steps within
    1e-10).  Per key (loss, grad norm, and each parameter, m and v by its
    relative Frobenius error) the card's error against the truth within
    tol or ``spread`` × the CPU's own float32 spread on that key: the
    largest of its two runs' errors (at microbatches 2 and 1) and their
    distance from each other.  Every MoE route equal.  The states are
    compared on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.testing import (float64_evaluation, moe_routes,
                                     widen_train_state)
    from repro_torch.train import OptConfig
    from repro_torch.train.steps import init_train_state
    p = TRAIN_KINDS_PARITY
    t_phase = time.perf_counter()
    opt = OptConfig()
    cpu_dev, dev = torch.device("cpu"), torch.device(DEVICE)
    mb = p["microbatches"]
    cases = []
    for arch, smoke, over in p["cases"]:
        base = get_smoke_config(arch) if smoke else get_config(arch)
        cfg = dataclasses.replace(base, dtype="float32", **over)
        label = f"train:kinds-parity {arch}"
        cpu = init_train_state(p["seed"], cfg, device=cpu_dev)
        cpu1, card = _copy_state(cpu, cpu_dev), _copy_state(cpu, dev)
        truth = widen_train_state(cpu)
        batches = _kinds_batches(cfg, p, cpu_dev)
        on_card = [{k: x.to(dev) for k, x in b.items()} for b in batches]
        t0 = time.perf_counter()
        with moe_routes() as want_plans:
            cpu_log = _run_steps(cpu, batches, cfg, opt, mb, cpu_dev)
        cpu_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        with moe_routes() as got_plans:
            card_log = _run_steps(card, on_card, cfg, opt, mb, dev)
        card_s = time.perf_counter() - t0
        launches = read_launches()
        # the truth at one microbatch: the same loss, grad norm and state
        # as at two, in float64, for less of the CPU's time
        t0 = time.perf_counter()
        with float64_evaluation():
            truth_log = _run_steps(truth, batches, cfg, opt, 1, cpu_dev)
        truth_s = time.perf_counter() - t0
        cpu1_log = _run_steps(cpu1, batches, cfg, opt, 1, cpu_dev)
        check(all(n == 0 for n in launches.values()),
              f"{label}: the training route launched a kernel: {launches}")
        check_step_syncs(card_log, label)
        check(int(card["step"]) == int(cpu["step"]) == p["steps"],
              f"{label}: step is not {p['steps']} on both")
        truth, cpu, cpu1 = (_copy_state(x, dev) for x in (truth, cpu, cpu1))

        def errors(state, log, want=truth, want_log=truth_log):
            out = _rel_errors(state, want)
            for key in ("loss", "grad_norm"):
                out[key] = max(abs(r[key] / w[key] - 1)
                               for r, w in zip(log, want_log))
            return out

        err = errors(card, card_log)
        own = {}
        for sample in (errors(cpu, cpu_log), errors(cpu1, cpu1_log),
                       errors(cpu, cpu_log, cpu1, cpu1_log)):
            own = {k: max(own.get(k, 0.0), e) for k, e in sample.items()}
        limit = {k: max(p["tol"], p["spread"] * own[k]) for k in err}
        beyond = {k: (err[k], limit[k]) for k in err if err[k] > limit[k]}
        check(not beyond, f"{label}: card against the float64 truth "
                          f"beyond the limit at {beyond}")
        check(len(got_plans) == len(want_plans),
              f"{label}: {len(got_plans)} MoE routes on the card, "
              f"{len(want_plans)} on the CPU")
        routes_equal = all(torch.equal(g[i].cpu(), w[i])
                           for g, w in zip(got_plans, want_plans)
                           for i in (0, 1, 3, 4))
        check(routes_equal, f"{label}: an MoE route differs between the "
                            f"card and the CPU")
        dropped = sum(int((~w[4]).sum()) for w in want_plans)
        n_plans = len(want_plans)
        if cfg.moe_experts and cfg.capacity_factor < cfg.moe_experts:
            check(dropped > 0, f"{label}: no assignment dropped at "
                               f"capacity factor {cfg.capacity_factor}")
        del want_plans, got_plans

        def worst(errors_):
            return {part: max(((k, e) for k, e in errors_.items()
                               if k.startswith(part + ":")),
                              key=lambda x: x[1])
                    for part in ("params", "m", "v")}

        ratio = max(err, key=lambda k: err[k] / limit[k])
        cases.append({
            "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "capacity_factor": cfg.capacity_factor,
            "losses_card": [r["loss"] for r in card_log],
            "losses_cpu": [r["loss"] for r in cpu_log],
            "card_vs_truth": dict(worst(err), loss=err["loss"],
                                  grad_norm=err["grad_norm"]),
            "cpu_spread": dict(worst(own), loss=own["loss"],
                               grad_norm=own["grad_norm"]),
            "closest_to_limit": (ratio, err[ratio], limit[ratio]),
            "moe_routes": n_plans, "moe_dropped": dropped,
            "launches": launches, "card_s": card_s, "cpu_s": cpu_s,
            "truth_s": truth_s})
        del cpu, cpu1, card, truth, batches, on_card
        torch.cuda.empty_cache()
    emit({"phase": "train:kinds-parity", "dtype": "float32",
          "tol": p["tol"], "spread": p["spread"], "cases": cases,
          "phase_s": time.perf_counter() - t_phase})


def phase_shard_parity():
    """shard:parity (module notes, 29)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_local_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.boundary import host_boundary
    from repro_torch.train import OptConfig
    from repro_torch.train import steps as tsteps
    p, q = TRAIN_SMALL, SHARD
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    started = not dist.is_initialized()
    mesh = make_local_mesh(DEVICE)
    try:
        cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                                  dtype="float32", n_layers=p["n_layers"])
        opt = OptConfig()
        plain = tsteps.init_train_state(p["seed"], cfg, device=dev)
        shard = _copy_state(plain, DEVICE)
        batches = _train_batches(cfg, p["seq"], p["batch"], 2, p["seed"],
                                 dev)
        kw = dict(opt=opt, global_batch=p["batch"],
                  microbatches=p["microbatches"])
        plain_fn, _, _ = tsteps.build_train_step(cfg, None, **kw)
        shard_fn, _, bspec = tsteps.build_train_step(cfg, mesh, **kw)
        logs = {"plain": [], "shard": []}
        for b in batches:
            for name, fn in (("plain", plain_fn), ("shard", shard_fn)):
                st = plain if name == "plain" else shard
                t0 = time.perf_counter()
                with host_boundary("train.step", dev,
                                   all_threads=True) as hb:
                    st, m = fn(st, b)
                with host_boundary("train.log", dev) as hb_log:
                    loss, gnorm = (float(x) for x in hb_log.read(
                        torch.stack([m["loss"], m["grad_norm"]])))
                logs[name].append({"loss": loss, "grad_norm": gnorm,
                                   "step_syncs": hb.syncs,
                                   "log_syncs": hb_log.syncs,
                                   "log_reads": hb_log.reads,
                                   "seconds": time.perf_counter() - t0})
        check_step_syncs(logs["shard"], "shard:parity")
        worst = {}
        for key in ("loss", "grad_norm"):
            worst[key] = max(abs(a[key] / b_[key] - 1) for a, b_ in
                             zip(logs["shard"], logs["plain"]))
            check(worst[key] <= p["tol"], f"shard:parity: {key} sharded "
                  f"{[r[key] for r in logs['shard']]} vs unsharded "
                  f"{[r[key] for r in logs['plain']]}")
        tsteps.gather_train_state(shard)
        errs = _rel_errors(shard, plain)
        for part in ("params", "m", "v"):
            name, err = max(((n, e) for n, e in errs.items()
                             if n.startswith(part + ":")),
                            key=lambda x: x[1])
            worst[part] = err
            check(err <= p["tol"], f"shard:parity: {name} sharded vs "
                  f"unsharded relative Frobenius error {err}")
        del plain, shard, batches
        torch.cuda.empty_cache()

        cfg8 = get_config(q["prefill_arch"])
        params = init_params(q["seed"], cfg8, device=dev)
        gen = torch.Generator(device=dev).manual_seed(q["seed"])
        toks = torch.randint(0, cfg8.vocab_size,
                             (q["batch"], q["prompt_len"]), generator=gen,
                             device=dev)
        f0, _, _ = tsteps.build_prefill_step(cfg8, None)
        f1, _, _ = tsteps.build_prefill_step(cfg8, mesh,
                                             global_batch=q["batch"])
        batch = {"tokens": toks}
        reset_launches()
        want = f0(params, batch)
        torch.cuda.synchronize()
        plain_launches = read_launches()
        reset_launches()
        got = f1(params, batch)
        torch.cuda.synchronize()
        shard_launches = read_launches()
        for label, lc in (("unsharded", plain_launches),
                          ("sharded", shard_launches)):
            check(lc["flash_attention"] == cfg8.n_layers,
                  f"shard:parity: the {label} prefill launched K4 "
                  f"{lc['flash_attention']} times, expected "
                  f"{cfg8.n_layers}")
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"shard:parity: prefill {got.shape} {got.dtype} vs "
              f"{want.shape} {want.dtype}")
        diff = float((got.float() - want.float()).abs().max())
        check(torch.equal(_bits(got), _bits(want)),
              f"shard:parity: the sharded K4 prefill differs from the "
              f"unsharded one (max |Δ| {diff})")
        shard_ms = cuda_ms(lambda: f1(params, batch), iters=3, warmup=1)
        # back to plain tensors for the unsharded timing
        params = init_params(q["seed"], cfg8, device=dev)
        plain_ms = cuda_ms(lambda: f0(params, batch), iters=3, warmup=1)
        del params, want, got
        torch.cuda.empty_cache()
    finally:
        if started:
            dist.destroy_process_group()
    emit({"phase": "shard:parity", "mesh": list(mesh.shape),
          "train": {"arch": TRAIN["arch"], "n_layers": p["n_layers"],
                    "dtype": "float32", "batch": p["batch"],
                    "seq": p["seq"], "microbatches": p["microbatches"],
                    "plain_losses": [r["loss"] for r in logs["plain"]],
                    "shard_losses": [r["loss"] for r in logs["shard"]],
                    "worst_rel": worst, "tol": p["tol"],
                    "shard_step_syncs": [r["step_syncs"]
                                         for r in logs["shard"]],
                    "plain_step_s": [r["seconds"] for r in logs["plain"]],
                    "shard_step_s": [r["seconds"] for r in logs["shard"]]},
          "prefill": {"arch": q["prefill_arch"], "n_layers": cfg8.n_layers,
                      "dtype": cfg8.dtype, "batch": q["batch"],
                      "prompt_len": q["prompt_len"], "bit_equal": True,
                      "k4_launches_sharded": shard_launches[
                          "flash_attention"],
                      "k4_launches_unsharded": plain_launches[
                          "flash_attention"],
                      "sharded_ms": shard_ms, "unsharded_ms": plain_ms},
          "phase_s": time.perf_counter() - t_phase})


# mesh:placement: the dry-run's granite-3-2b train_4k cell on the multi
# mesh (2, 16, 16) at full width and depth, its collective record mapped
# onto the tree fleet of 2 pods; decode_32k retraced on the placed and
# the identity layout; the card's order held to the CPU's, or its J
# within objective_rtol relative where the float32 sums differ
PLACEMENT = {"arch": "granite-3-2b", "shape": "train_4k",
             "placed_shape": "decode_32k", "devices": 512, "pods": 2,
             "machine_model": "tree", "objective_rtol": 1e-6}


def placement_kernels(mon, q) -> dict:
    """K2 at the monitor's candidate pairs and K1 at its incumbent, on
    the record's graph and the fleet's form at the plan's bucket shapes
    (the tensors the plan's sweep gives them), each held against its
    plain version on the same inputs.  K2 per pair within K · 2⁻²³ of
    the pair's Σ|w| · d_max over its two rows: the float32 rounding
    bound of two K-slot sums taken in different orders (the record's
    weights are bytes, not integers below 2²⁴, so the kernel's
    in-order sum and torch's reduction may differ in the last bits;
    bit-equality is reported beside it).  K1 within ``objective_rtol``
    relative.  Outside the main path's launch window."""
    import numpy as np
    import torch

    from repro_torch.kernels import (pair_gains, pair_gains_plain,
                                     qap_objective_edges,
                                     qap_objective_plain)
    eng = mon.plan.engines[0]
    dg, us, vs = eng.shared_inputs(mon.baseline, mon.pairs,
                                   mon.plan.bucket)
    perm = torch.from_numpy(mon.incumbent.astype(np.int32)).to(DEVICE)
    cfg = eng.kernel_config
    args = (eng.kind, eng.params, dg.nbr, dg.wgt, perm, us, vs, eng._D)
    got = pair_gains(*args, config=cfg)
    want = pair_gains_plain(*args, config=cfg)
    d_max = float(np.max(eng.topology.matrix()))
    row = dg.wgt.abs().sum(dim=1)
    scale = (row[us.long()] + row[vs.long()]) * d_max
    err = torch.abs(got - want)
    worst = float(torch.max(err / torch.clamp(scale, min=1.0)))
    gain_rtol = dg.max_deg * 2.0 ** -23
    check(worst <= gain_rtol, f"mesh:placement: K2 at the plan's pairs "
          f"off its plain version by {worst} of Σ|w|·d_max (limit "
          f"{gain_rtol})")
    p = len(mon.pairs)
    check(bool(torch.all(got[p:] == 0.0)),
          "mesh:placement: K2's padding pairs have nonzero gain")
    eargs = (eng.kind, eng.params, dg.eu, dg.ev, dg.ew, perm, eng._D)
    j_kernel = float(qap_objective_edges(*eargs))
    j_plain = float(qap_objective_plain(*eargs))
    j_rel = abs(j_kernel - j_plain) / max(abs(j_plain), 1.0)
    check(j_rel <= q["objective_rtol"], f"mesh:placement: K1 at the "
          f"incumbent {j_kernel} vs plain {j_plain} (relative {j_rel})")
    return {"pairs": p, "P": int(us.shape[0]), "K": int(dg.max_deg),
            "E": int(dg.eu.shape[0]),
            "k2_max_abs_err": float(torch.max(err)),
            "k2_max_rel_err": worst, "k2_rtol": gain_rtol,
            "k2_bit_equal": bool(torch.equal(got, want)),
            "k2_positive": int(torch.sum(got[:p] > 0)),
            "k2_max_gain": float(torch.max(want[:p])),
            "k1_kernel": j_kernel, "k1_plain": j_plain, "k1_rel_err": j_rel}


def phase_mesh_placement():
    """mesh:placement (module notes, 30)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import qap_objective
    from repro_torch.core.comm_model import device_comm_graph
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fleet_model, fleet_monitor
    q = PLACEMENT
    n = q["devices"]
    t_phase = time.perf_counter()
    check(not dist.is_initialized(), "mesh:placement: a process group is "
          "still up after shard:parity")
    dryrun.init_fake_group(n)
    try:
        t0 = time.perf_counter()
        row = dryrun.run_cell(q["arch"], q["shape"], True, save=False)
        trace_s = time.perf_counter() - t0
        check(row["status"] == "ok", f"mesh:placement: the {q['shape']} "
              f"trace failed: {row.get('error')}")
        record = row["collective_record"]
        g = device_comm_graph(record, n)
        parts = {}
        for name, dcn in (("ici", False), ("dcn", True)):
            part = [(op, groups, nbytes, calls)
                    for op, dims, groups, nbytes, calls in record.instances
                    if ("pod" in dims) == dcn]
            pg = device_comm_graph(part, n)
            parts[name] = {"instances": len(part),
                           "edges": int(pg.num_edges),
                           "gib_per_step": pg.total_edge_weight() / 2 ** 30}
        kw = dict(pods=q["pods"], machine_model=q["machine_model"])
        reset_launches()
        t0 = time.perf_counter()
        mon, order = fleet_monitor(record, n, device=DEVICE, **kw)
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        launches = read_launches()
        check_launched(launches, MAP_KERNELS, "mesh:placement")
        check(sorted(order.tolist()) == list(range(n)),
              "mesh:placement: the card's order is no permutation")
        h = fleet_model(q["machine_model"], pods=q["pods"])
        j_order = qap_objective(g, h, order)
        j_identity = qap_objective(g, h, np.arange(n))
        check(j_order <= j_identity, f"mesh:placement: J {j_order} of the "
              f"order above the identity's {j_identity}")
        t0 = time.perf_counter()
        _, order_cpu = fleet_monitor(record, n, device="cpu", **kw)
        cpu_map_s = time.perf_counter() - t0
        j_cpu = qap_objective(g, h, order_cpu)
        same_order = bool(np.array_equal(order, order_cpu))
        j_rel = abs(j_order - j_cpu) / max(abs(j_cpu), 1.0)
        check(same_order or j_rel <= q["objective_rtol"],
              f"mesh:placement: the card's J {j_order} vs the CPU's "
              f"{j_cpu} (relative {j_rel})")
        held = placement_kernels(mon, q)
        t0 = time.perf_counter()
        mon.observe_hlo(record)
        tick = mon.tick()
        tick_s = time.perf_counter() - t0
        check(not tick.remapped and mon.remaps == 0,
              f"mesh:placement: the quiet tick remapped ({tick})")
        t0 = time.perf_counter()
        rows = {label: dryrun.run_cell(q["arch"], q["placed_shape"], True,
                                       save=False, devices=devices,
                                       tag=label)
                for label, devices in (("placed", order),
                                       ("identity", None))}
        retrace_s = time.perf_counter() - t0
        for label, r in rows.items():
            check(r["status"] == "ok", f"mesh:placement: the {label} "
                  f"{q['placed_shape']} trace failed: {r.get('error')}")
        check(rows["placed"]["collective_record"]
              == rows["identity"]["collective_record"],
              "mesh:placement: the placed mesh's record differs from the "
              "identity mesh's")
    finally:
        dist.destroy_process_group()
    emit({"phase": "mesh:placement", "arch": q["arch"], "shape": q["shape"],
          "mesh": [2, 16, 16], "devices": n,
          "machine_model": q["machine_model"],
          "record_instances": len(record.instances),
          "graph": {"edges": int(g.num_edges),
                    "gib_per_step": g.total_edge_weight() / 2 ** 30,
                    **parts},
          "row_ici_s": row["ici_s"], "row_dcn_s": row["dcn_s"],
          "j_identity": j_identity, "j_order": j_order, "j_cpu": j_cpu,
          "order_is_identity": bool(np.array_equal(order, np.arange(n))),
          "same_order_as_cpu": same_order, "j_rel_to_cpu": j_rel,
          "launches": {k: launches[k] for k in MAP_KERNELS},
          "kernels_held": held,
          "tick": {"remapped": tick.remapped, "triggered": tick.triggered,
                   "drift": tick.drift.score},
          "placed_shape": q["placed_shape"], "placed_record_equal": True,
          "trace_s": trace_s, "map_s": map_s, "cpu_map_s": cpu_map_s,
          "tick_s": tick_s, "retrace_s": retrace_s,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one CUDA card (see the module notes).")
    ap.add_argument("--stop-after", choices=("build", "kernels", "lint",
                                             "portfolio", "remap",
                                             "service"),
                    help="run the phases up to this one and stop, with "
                         "no kernels line and no result line")
    args = ap.parse_args(argv)
    t_run = time.perf_counter()
    preflight()
    import torch

    from repro_torch.testing import warm_cpu_math
    # full float32 products in the plain versions and the library call
    torch.backends.cuda.matmul.allow_tf32 = False
    # the CPU sides' first multi-threaded cos may be ~1.5e-4 off
    warm_cpu_math()
    card = phase_device()
    phase_build()
    if args.stop_after == "build":
        return 0
    forms = machines()
    k1, k2 = phase_kernels(forms)
    if args.stop_after == "kernels":
        return 0
    phase_lint()
    if args.stop_after == "lint":
        return 0
    from repro_torch.core import Hierarchy, grid3d
    from repro_torch.topology import (FatTreeTopology, MatrixTopology,
                                      TorusTopology)
    from repro_torch.topology.base import as_topology
    side = SIZE["side"]
    main_topo = as_topology(Hierarchy.from_strings(SIZE["hierarchy"],
                                                   SIZE["distances"]))
    main_g = grid3d(side, side, side)
    pf = phase_portfolio(main_topo, main_g)
    phase_portfolio_cpu()
    if args.stop_after == "portfolio":
        return 0
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
    remap = phase_remap(main_topo, main_g, main_perm)
    phase_remap_bench()
    if args.stop_after == "remap":
        return 0
    service = phase_service(main_topo)
    phase_service_bench()
    phase_placement()
    if args.stop_after == "service":
        return 0
    k3, gain_launches = phase_gain(main_topo, main_g, main_perm, main_pairs,
                                   forms)
    k4, k4_worst = phase_flash()
    serve_launches, f32_launches = phase_serve(k4["serve"]["ms"])
    phase_train_parity()
    phase_train()
    phase_train_checkpoint()
    phase_serve_hybrid()
    phase_serve_rwkv()
    phase_lm_parity()
    for label in TRAIN_KINDS:
        phase_train_kind(label)
    phase_train_kinds_parity()
    phase_shard_parity()
    placement_launches = phase_mesh_placement()
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
            # and the device time of one launch of LANES lanes; the
            # shared graph: launches in the portfolio map and the device
            # time of one launch of PORTFOLIO_LANES lanes over one graph
            kernels[-1].update(
                batch_launches=batch_ml["batch_launches"][name],
                batch_ms=rec["batch_ms"],
                portfolio_launches=pf["launches"][name],
                shared_ms=rec["shared_ms"],
                remap_launches=remap["remap_launches"][name],
                service_launches=service["launches"][name],
                placement_launches=placement_launches[name])
    emit({"phase": "total", "seconds": time.perf_counter() - t_run})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
