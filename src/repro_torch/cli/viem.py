"""`viem` — the mapping program (guide §4.1) on the PyTorch/CUDA port.

Usage:
    python -m repro_torch.cli.viem graph.metis \
        --hierarchy_parameter_string=4:16:64 \
        --distance_parameter_string=1:10:100 \
        [--topology=torus --topology_params='{"dims": [16, 16, 16]}'] \
        [--distance_matrix_file=D.metis]    # explicit matrix (sparse QAP)
        [--seed=0] [--preconfiguration_mapping=eco]
        [--construction_algorithm=hierarchytopdown]
        [--distance_construction_algorithm=hierarchyonline]
        [--local_search_neighborhood=communication]
        [--communication_neighborhood_dist=10]
        [--engine=host|device]            # host numpy drivers / sweep engine
        [--multilevel] [--multilevel_levels=N] [--multilevel_coarsen_min=N]
        [--portfolio] [--portfolio_lanes=8] [--portfolio_rounds=4]
        [--portfolio_tabu_tenure=8] [--portfolio_kick=0.15]
        [--portfolio_stagnation=3]
        [--parallel_sweeps]               # host engine: batched sweeps
        [--backend=numpy|pallas]          # pallas: the CUDA objective
        [--kernel_block_rows=N] [--kernel_lanes=N]
        [--kernel_quantize={auto,off,int8,int16}]
        [--config=spec.json]              # load a MappingSpec (flags override)
        [--device=cuda|cpu]               # default cuda; never falls back
        [--explain] [--telemetry]
        [--profile=trace.json]            # Chrome trace of the run's spans
        [--metrics-out=metrics.prom]      # the run's metrics, Prometheus text
        [--output_filename=permutation]
    python -m repro_torch.cli.viem remap-watch graph.metis ...  # closed loop
    python -m repro_torch.cli.viem lint [paths] [--runtime-audit]  # lint
    python -m repro_torch.cli.viem --list-algorithms

The flags are the JAX package's ``repro.cli.viem`` flags, and the
defaults are its defaults (``engine="host"`` with the communication
neighborhood; ``--multilevel`` selects the V-cycle over the device
engine, its knobs following ``--preconfiguration_mapping``;
``--portfolio`` the multistart search over the device engine;
``remap-watch`` the closed remapping loop, :mod:`.remap_watch`; ``lint``
the invariant lint engine and runtime audit, :mod:`repro_torch.staticcheck`,
which exits with its own status).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..core import Mapper, MappingSpec, list_constructions, \
    list_neighborhoods, read_metis
from .machine import add_topology_flags, machine_flags_given, \
    topology_from_args


def _print_algorithms():
    from ..topology import list_topologies
    print("constructions:")
    for name in list_constructions():
        print(f"  {name}")
    print("neighborhoods:")
    for name in list_neighborhoods():
        print(f"  {name}")
    print("  none  (skip local search)")
    print("topologies:")
    for name in list_topologies():
        print(f"  {name}")


def build_spec(args) -> MappingSpec:
    """--config (if given) seeds the spec; explicit flags override it."""
    base = None
    if args.config:
        base = MappingSpec.from_json(Path(args.config).read_text())
    return MappingSpec.from_flags(args, base=base).validate()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="viem", description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("file", nargs="?", help="Path to file (model).")
    ap.add_argument("--list-algorithms", action="store_true",
                    help="print registered algorithms and exit")
    ap.add_argument("--config", default=None,
                    help="path to a MappingSpec JSON; explicit flags "
                         "override values from the file")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--preconfiguration_mapping", "--preconfiguration",
                    default=None, choices=["strong", "eco", "fast"])
    ap.add_argument("--construction_algorithm", default=None,
                    choices=list_constructions())
    ap.add_argument("--distance_construction_algorithm", default="hierarchy",
                    choices=["hierarchy", "hierarchyonline"])
    add_topology_flags(ap)
    ap.add_argument("--local_search_neighborhood", default=None,
                    choices=list_neighborhoods() + ["none"])
    ap.add_argument("--communication_neighborhood_dist", type=int,
                    default=None)
    ap.add_argument("--parallel_sweeps",
                    action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument("--engine", default=None, choices=["host", "device"],
                    help="where the refinement loop runs: the host numpy "
                         "search drivers (default) or the device sweep "
                         "engine")
    ap.add_argument("--backend", default=None, choices=["numpy", "pallas"],
                    help="objective evaluation: host float64 (numpy) or "
                         "the hand-written CUDA objective kernel (the "
                         "serialized name 'pallas' is kept)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the port runs on (default cuda; no card "
                         "is an error, never a fallback)")
    ap.add_argument("--explain", action="store_true",
                    help="lower the plan for this graph WITHOUT executing "
                         "and pretty-print plan.describe()")
    ap.add_argument("--multilevel",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="coarsen → map → uncoarsen V-cycle over the "
                         "device engine (repro_torch.multilevel); knob "
                         "defaults follow --preconfiguration_mapping")
    ap.add_argument("--multilevel_levels", type=int, default=None,
                    help="max V-cycle levels incl. the finest (1 = flat, "
                         "bit-identical to the plain device engine)")
    ap.add_argument("--multilevel_coarsen_min", type=int, default=None,
                    help="stop contracting below this many coarse "
                         "vertices")
    ap.add_argument("--portfolio",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="device-side portfolio search: multistart lanes "
                         "with tabu memory, perturbation kicks, and "
                         "tournament selection (repro_torch.portfolio)")
    ap.add_argument("--portfolio_lanes", type=int, default=None,
                    help="restart trajectories per request (one sweep "
                         "loop; 1 = single-trajectory)")
    ap.add_argument("--portfolio_rounds", type=int, default=None,
                    help="refine rounds at the finest level (rounds-1 "
                         "perturb→refine rounds after the first)")
    ap.add_argument("--portfolio_tabu_tenure", type=int, default=None,
                    help="sweeps of tabu memory per applied exchange "
                         "(0 = monotone sweep, bit-identical)")
    ap.add_argument("--portfolio_kick", type=float, default=None,
                    help="fraction of vertices each between-round "
                         "perturbation kick touches")
    ap.add_argument("--portfolio_stagnation", type=int, default=None,
                    help="stop after this many rounds without improving "
                         "the incumbent")
    ap.add_argument("--kernel_block_rows", type=int, default=None)
    ap.add_argument("--kernel_lanes", type=int, default=None)
    ap.add_argument("--kernel_quantize", default=None,
                    choices=["auto", "off", "int8", "int16"])
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="record the run's spans (with the engine's "
                         "per-sweep counters) as a Chrome trace_event "
                         "JSON for Perfetto")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect the engine's per-sweep counters and "
                         "print a summary")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="write the run's metrics as Prometheus text")
    ap.add_argument("--output_filename", default="permutation")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "remap-watch":
        # the closed-loop monitor driver (repro_torch.monitor): profile →
        # drift → what-if replay → incremental remap
        from .remap_watch import main as remap_watch_main
        return remap_watch_main(argv[1:])
    if argv and argv[0] == "lint":
        # the invariant lint engine (repro_torch.staticcheck): VIEM001,
        # VIEM003 and VIEM004 AST rules + the runtime audit; its exit
        # status is the command's (0 clean, 1 findings)
        from ..staticcheck.__main__ import main as lint_main
        sys.exit(lint_main(argv[1:]))
    ap = _parser()
    args = ap.parse_args(argv)

    if args.list_algorithms:
        _print_algorithms()
        return

    if not args.file:
        ap.error("the graph file argument is required")

    try:
        spec = build_spec(args)
        # the machine model: explicit CLI flags win; otherwise a machine
        # carried inside --config (spec.topology) is honored
        if spec.topology is not None and not machine_flags_given(args):
            topo = spec.topology.build()
        else:
            topo = topology_from_args(args)
    except (ValueError, OSError) as exc:
        sys.exit(f"viem: {exc}")
    g = read_metis(args.file)
    if g.n != topo.n_pe:
        sys.exit(f"viem: model has {g.n} vertices but the machine "
                 f"specifies {topo.n_pe} PEs — they must match (guide §4.1)")
    try:
        mapper = Mapper(topo, spec, device=args.device)
        if args.explain:
            import json
            print(json.dumps(mapper.lower_for(g).describe(), indent=2))
            return
        tracer = None
        if args.profile:
            from ..obs import get_tracer
            tracer = get_tracer()
            tracer.enable()
        telemetry = args.telemetry or bool(args.profile)
        res = mapper.map(g, telemetry=telemetry)
    except (NotImplementedError, RuntimeError) as exc:
        sys.exit(f"viem: {exc}")
    np.savetxt(args.output_filename, res.perm, fmt="%d")
    print(f"machine topology     = {topo.kind} ({topo.n_pe} PEs)")
    print(f"device               = {mapper.device}")
    print(f"initial objective  J = {res.initial_objective:.6g}")
    print(f"final objective    J = {res.final_objective:.6g}")
    print(f"improvement          = {res.improvement:.2%}")
    print(f"construction time    = {res.construction_seconds:.3f}s")
    print(f"local search time    = {res.search_seconds:.3f}s")
    tel = None if res.search_stats is None else res.search_stats.telemetry
    if telemetry and tel is not None:
        s = tel.summary()
        print(f"engine sweeps        = {s['sweeps']} "
              f"(passes {s['passes']})")
        print(f"engine exchanges     = {s['exchanges']}")
        print(f"tabu masked pairs    = {s['tabu_masked']}")
        print(f"aspiration fires     = {s['aspiration_fires']} "
              f"(rate {s['aspiration_rate']:.3f}/pass)")
        print(f"downhill escapes     = {s['downhill_escapes']}")
    if tracer is not None:
        from ..obs import write_chrome_trace
        n_events = write_chrome_trace(tracer.spans(), args.profile)
        print(f"wrote {args.profile} ({len(tracer)} spans, "
              f"{n_events} trace events)")
    if args.metrics_out:
        _write_metrics(args.metrics_out, res, tel)
    print(f"wrote {args.output_filename}")


def _write_metrics(path, res, tel) -> None:
    """The run's objectives, phase seconds and engine counters as
    Prometheus text (the names of ``repro.cli.viem --metrics-out``)."""
    from ..obs import MetricsRegistry
    reg = MetricsRegistry()
    with reg.lock:
        reg.counter("run.count").inc()
        reg.gauge("run.initial_objective").set(res.initial_objective)
        reg.gauge("run.final_objective").set(res.final_objective)
        reg.gauge("run.improvement").set(res.improvement)
        reg.histogram("run.construction_seconds").observe(
            res.construction_seconds)
        reg.histogram("run.search_seconds").observe(res.search_seconds)
        if tel is not None:
            s = tel.summary()
            reg.counter("engine.sweeps").inc(s["sweeps"])
            reg.counter("engine.exchanges").inc(s["exchanges"])
            reg.counter("engine.tabu_masked").inc(s["tabu_masked"])
    with open(path, "w") as fh:
        fh.write(reg.to_prometheus())
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
