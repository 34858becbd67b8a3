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
        [--parallel_sweeps]               # host engine: batched sweeps
        [--backend=numpy|pallas]          # pallas: the CUDA objective
        [--kernel_block_rows=N] [--kernel_lanes=N]
        [--kernel_quantize={auto,off,int8,int16}]
        [--config=spec.json]              # load a MappingSpec (flags override)
        [--device=cuda|cpu]               # default cuda; never falls back
        [--explain] [--telemetry]
        [--output_filename=permutation]
    python -m repro_torch.cli.viem --list-algorithms

The flags are the JAX package's ``repro.cli.viem`` flags, and the
defaults are its defaults (``engine="host"`` with the communication
neighborhood; ``--multilevel`` selects the V-cycle over the device
engine, its knobs following ``--preconfiguration_mapping``).  Those of
paths the port has not taken over yet — ``--portfolio*``,
``--profile``, ``--metrics-out`` and the ``remap-watch``/``lint``
subcommands — exit with an error that names the ROADMAP item.
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

# flags accepted for compatibility with repro.cli.viem that select paths
# the port does not have yet: flag -> (what, ROADMAP queue-1 item)
_UNPORTED_FLAGS = {
    "profile": ("--profile (Chrome trace export)", 10),
    "metrics_out": ("--metrics-out (metrics registry)", 10),
}
_UNPORTED_COMMANDS = {"remap-watch": 10, "lint": 8}


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
    ap.add_argument("--portfolio", action=argparse.BooleanOptionalAction,
                    default=None, help="not ported yet (exits)")
    for flag, typ in (("--portfolio_lanes", int),
                      ("--portfolio_rounds", int),
                      ("--portfolio_tabu_tenure", int),
                      ("--portfolio_kick", float),
                      ("--portfolio_stagnation", int)):
        ap.add_argument(flag, type=typ, default=None,
                        help="not ported yet (exits)")
    ap.add_argument("--kernel_block_rows", type=int, default=None)
    ap.add_argument("--kernel_lanes", type=int, default=None)
    ap.add_argument("--kernel_quantize", default=None,
                    choices=["auto", "off", "int8", "int16"])
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="not ported yet (exits)")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect the engine's per-sweep counters and "
                         "print a summary")
    ap.add_argument("--metrics-out", metavar="FILE", default=None,
                    help="not ported yet (exits)")
    ap.add_argument("--output_filename", default="permutation")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _UNPORTED_COMMANDS:
        sys.exit(f"viem: the {argv[0]!r} subcommand is not ported to "
                 f"repro_torch yet (ROADMAP.md queue 1, item "
                 f"{_UNPORTED_COMMANDS[argv[0]]})")
    ap = _parser()
    args = ap.parse_args(argv)

    if args.list_algorithms:
        _print_algorithms()
        return

    if not args.file:
        ap.error("the graph file argument is required")
    for dest, (what, item) in _UNPORTED_FLAGS.items():
        if getattr(args, dest) is not None:
            sys.exit(f"viem: {what} is not ported to repro_torch yet "
                     f"(ROADMAP.md queue 1, item {item})")

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
        res = mapper.map(g, telemetry=args.telemetry)
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
    if args.telemetry and tel is not None:
        s = tel.summary()
        print(f"engine sweeps        = {s['sweeps']} "
              f"(passes {s['passes']})")
        print(f"engine exchanges     = {s['exchanges']}")
        print(f"tabu masked pairs    = {s['tabu_masked']}")
        print(f"aspiration fires     = {s['aspiration_fires']} "
              f"(rate {s['aspiration_rate']:.3f}/pass)")
        print(f"downhill escapes     = {s['downhill_escapes']}")
    print(f"wrote {args.output_filename}")


if __name__ == "__main__":
    main()
