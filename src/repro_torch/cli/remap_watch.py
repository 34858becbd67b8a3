"""`viem remap-watch` — drive the closed remapping loop from the CLI, on
the PyTorch/CUDA port (the JAX package's ``cli/remap_watch.py`` with a
``--device`` flag).

Maps the baseline graph once, then replays a stream of traffic windows
through the monitor, printing one decision line per window:

    python -m repro_torch.cli.viem remap-watch graph.metis \
        --hierarchy_parameter_string=4:8:16 \
        --distance_parameter_string=1:10:100 \
        [--windows=8] [--window-file=w1.metis ...]   # live windows
        [--inject-shift=3 --shift-factor=8 --shift-frac=0.25]
        [--jitter=0.01] [--alpha=0.5]
        [--drift-high=0.1 --drift-low=0.05 --patience=2]
        [--margin=0.02] [--dirty-hops=1] [--dirty-rel-tol=0.05]
        [--evict-host=N]      # simulated straggler REBALANCE signal
        [--profile=trace.json] [--metrics-out=metrics.prom]
        [--device=cuda|cpu]   # default cuda; never falls back

Without ``--window-file`` the windows are synthesized from the baseline:
multiplicative jitter every window, plus — from ``--inject-shift``
onwards — a sustained traffic shift multiplying every edge incident to
a random ``--shift-frac`` of vertices by ``--shift-factor``.  The
decision spans land in the ``--profile`` Perfetto trace; the monitor
counters land in ``--metrics-out`` (Prometheus text).  On the card
every warm remap runs K2 (pair gains) and K1 (objective); ``--device
cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import Mapper, MappingSpec, read_metis
from ..core.graph import from_edges
from .machine import add_topology_flags, topology_from_args


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="viem remap-watch",
                                 description=__doc__)
    ap.add_argument("file", help="baseline communication graph (METIS)")
    add_topology_flags(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preconfiguration_mapping", "--preconfiguration",
                    dest="preconfiguration_mapping", default="eco",
                    choices=["strong", "eco", "fast"])
    ap.add_argument("--communication_neighborhood_dist", type=int,
                    default=10)
    ap.add_argument("--windows", type=int, default=8,
                    help="number of synthesized traffic windows")
    ap.add_argument("--window-file", action="append", default=None,
                    metavar="GRAPH",
                    help="explicit per-window traffic graph (repeatable; "
                         "overrides synthesis)")
    ap.add_argument("--jitter", type=float, default=0.01,
                    help="multiplicative weight noise per window")
    ap.add_argument("--inject-shift", type=int, default=None,
                    metavar="WINDOW",
                    help="from this window on, scale a vertex subset's "
                         "traffic by --shift-factor")
    ap.add_argument("--shift-factor", type=float, default=8.0)
    ap.add_argument("--shift-frac", type=float, default=0.25)
    ap.add_argument("--evict-host", type=int, default=None,
                    help="simulate a straggler on this host index "
                         "(REBALANCE through the replay gate)")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="profiler EMA weight of the newest window")
    ap.add_argument("--drift-high", type=float, default=0.10)
    ap.add_argument("--drift-low", type=float, default=0.05)
    ap.add_argument("--patience", type=int, default=2)
    ap.add_argument("--margin", type=float, default=0.02,
                    help="replay gate: required relative step-time win")
    ap.add_argument("--dirty-hops", type=int, default=1)
    ap.add_argument("--dirty-rel-tol", type=float, default=0.05)
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None)
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="write the monitor registry as Prometheus text")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the port runs on (default cuda; no card "
                         "is an error, never a fallback)")
    args = ap.parse_args(argv)

    from ..monitor import MonitorConfig, RemapMonitor
    from ..runtime.fault_tolerance import Action

    try:
        topo = topology_from_args(args)
        g = read_metis(args.file)
    except (ValueError, OSError) as exc:
        sys.exit(f"viem remap-watch: {exc}")
    if g.n != topo.n_pe:
        sys.exit(f"viem remap-watch: model has {g.n} vertices but the "
                 f"machine specifies {topo.n_pe} PEs")
    tracer = None
    if args.profile:
        from ..obs import get_tracer
        tracer = get_tracer()
        tracer.enable()
    spec = MappingSpec(
        construction="hierarchytopdown", neighborhood="communication",
        neighborhood_dist=args.communication_neighborhood_dist,
        preconfiguration=args.preconfiguration_mapping,
        engine="device", seed=args.seed)
    # pow2 bucket headroom: drifted windows keep fitting the padded shapes
    try:
        plan = Mapper(topo, spec, device=args.device).lower_for(
            g, schedule="pow2")
    except RuntimeError as exc:
        sys.exit(f"viem remap-watch: {exc}")
    cfg = MonitorConfig(
        alpha=args.alpha, min_weight=0.0, drift_high=args.drift_high,
        drift_low=args.drift_low, drift_patience=args.patience,
        replay_margin=args.margin, dirty_rel_tol=args.dirty_rel_tol,
        dirty_hops=args.dirty_hops, telemetry=args.telemetry)
    mon = RemapMonitor(plan, g, config=cfg, seed=args.seed)
    print(f"baseline J = {plan.objective(g, mon.incumbent):.6g} "
          f"({topo.kind}, {topo.n_pe} PEs)")

    if args.window_file:
        windows = [read_metis(f) for f in args.window_file]
    else:
        rng = np.random.default_rng(args.seed)
        u, v, w = g.edge_list()
        shifted = np.zeros(g.n, dtype=bool)
        shifted[rng.permutation(g.n)[:max(1, int(args.shift_frac
                                                 * g.n))]] = True
        windows = []
        for t in range(args.windows):
            wt = w * rng.uniform(1 - args.jitter, 1 + args.jitter,
                                 size=len(w))
            if args.inject_shift is not None and t >= args.inject_shift:
                wt = np.where(shifted[u] | shifted[v],
                              wt * args.shift_factor, wt)
            windows.append(from_edges(g.n, u, v, wt))

    for t, win in enumerate(windows):
        if args.evict_host is not None and t == len(windows) // 2:
            mon.handle_action(Action.REBALANCE, [args.evict_host])
            print(f"window {t}: injected REBALANCE(host="
                  f"{args.evict_host})")
        mon.observe_graph(win)
        r = mon.tick()
        verdict = ("" if r.verdict is None else
                   f" win={r.verdict.predicted_improvement:+.2%}"
                   f" J {r.verdict.objective_incumbent:.6g}->"
                   f"{r.verdict.objective_candidate:.6g}")
        state = ("remapped" if r.remapped
                 else r.skipped or ("rejected" if r.verdict else
                                    ("armed" if r.drift.armed else
                                     "disarmed")))
        forced = f" forced={r.forced_by}" if r.forced_by else ""
        print(f"window {t}: score={r.drift.score:.4f} "
              f"l1={r.drift.l1:.4f} dJ={r.drift.objective_delta:+.4f} "
              f"{state}{forced} dirty={r.dirty} "
              f"active={r.active_pairs}/{len(mon.pairs)} "
              f"retraces={r.retraces}{verdict}")

    print(f"remaps committed     = {mon.remaps}")
    print(f"final objective    J = "
          f"{plan.objective(windows[-1], mon.incumbent):.6g} (last window)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as fh:
            fh.write(mon.registry.to_prometheus())
        print(f"wrote {args.metrics_out}")
    if tracer is not None:
        from ..obs import write_chrome_trace
        n_events = write_chrome_trace(tracer.spans(), args.profile)
        print(f"wrote {args.profile} ({len(tracer)} spans, "
              f"{n_events} trace events)")


if __name__ == "__main__":
    main()
