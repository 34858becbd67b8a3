"""`evaluator` — compute the QAP objective of a given mapping (guide §4.4),
on the PyTorch/CUDA port.

The mapping is scored against the same machine model it was built for:
the tree hierarchy flags, or ``--topology`` / ``--distance_matrix_file``
for any other registered machine model (same flags as ``viem``).

``--compare_spec spec.json`` additionally runs VieM with that
:class:`MappingSpec` and reports how the given mapping stacks up against
what the solver would produce; that solve runs on ``--device`` (default
``cuda``; no card is an error, never a fallback).  The lines printed are
the JAX package's ``repro.cli.evaluator``'s.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..core import Mapper, MappingSpec, qap_objective, read_metis
from ..core.comm_model import logical_traffic_summary
from .machine import add_topology_flags, topology_from_args


def main(argv=None):
    ap = argparse.ArgumentParser(prog="evaluator", description=__doc__)
    ap.add_argument("file", help="Path to file (graph/model).")
    ap.add_argument("--input_mapping", required=True)
    add_topology_flags(ap)
    ap.add_argument("--compare_spec", default=None,
                    help="MappingSpec JSON: also solve with this spec and "
                         "print the comparison")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the --compare_spec solve (default "
                         "cuda; no card is an error, never a fallback)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="with --compare_spec: solve with N consecutive "
                         "seeds (spec.seed .. spec.seed+N-1) and report "
                         "best/median/spread — the multistart variance "
                         "portfolio search collapses")
    args = ap.parse_args(argv)
    if args.seeds < 1:
        sys.exit("evaluator: --seeds must be >= 1")

    g = read_metis(args.file)
    try:
        topo = topology_from_args(args)
    except (ValueError, OSError) as exc:
        sys.exit(f"evaluator: {exc}")
    perm = np.loadtxt(args.input_mapping, dtype=np.int64)
    if sorted(perm) != list(range(g.n)):
        sys.exit("evaluator: mapping is not a permutation of 0..n-1")
    if g.n != topo.n_pe:
        sys.exit(f"evaluator: model has {g.n} vertices but the machine "
                 f"specifies {topo.n_pe} PEs — they must match")
    j = qap_objective(g, topo, perm)
    print(f"machine topology    = {topo.kind} ({topo.n_pe} PEs)")
    print(f"objective J(C,D,Pi) = {j:.6g}")
    if hasattr(topo, "hierarchy"):     # per-level traffic is tree-specific
        for k, v in logical_traffic_summary(g, topo.hierarchy,
                                            perm).items():
            print(f"  {k} = {v:.6g}")
    if args.compare_spec:
        try:
            spec = MappingSpec.from_json(
                Path(args.compare_spec).read_text()).validate()
            # staged explicitly so the plan geometry is reportable (and
            # so every seed reuses the one compiled plan)
            plan = Mapper(topo, spec, device=args.device).lower_for(g)
            results = [plan.execute(g, seed=spec.seed + i)
                       for i in range(args.seeds)]
        except (ValueError, OSError, NotImplementedError,
                RuntimeError) as exc:
            sys.exit(f"evaluator: {exc}")
        js = sorted(r.final_objective for r in results)
        best = js[0]
        ratio = j / best if best else float("inf")
        print(f"viem[{spec.construction}+{spec.neighborhood}] "
              f"J = {best:.6g}")
        if args.seeds > 1:
            median = float(np.median(js))
            print(f"viem seeds          = {args.seeds} "
                  f"(seed {spec.seed}..{spec.seed + args.seeds - 1})")
            print(f"viem best/median    = {best:.6g} / {median:.6g}")
            print(f"viem spread         = {js[-1] - js[0]:.6g} "
                  f"(worst {js[-1]:.6g})")
        print(f"viem plan           = bucket {plan.bucket.tag()}, "
              f"{len(plan.machines)} level(s), engine={spec.engine}")
        print(f"given/viem ratio    = {ratio:.3f}")


if __name__ == "__main__":
    main()
