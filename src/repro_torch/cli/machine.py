"""Shared machine-model flags for the `viem` and `evaluator` CLIs.

The guide's tree flags stay primary (``--hierarchy_parameter_string`` /
``--distance_parameter_string``); ``--topology`` selects any registered
machine model instead, parameterized by ``--topology_params`` (a JSON
object passed to the backend factory) or, for explicit matrices,
``--distance_matrix_file`` (Metis graph / .npy / dense text — guide §3).
"""

from __future__ import annotations

import json


def add_topology_flags(ap) -> None:
    from ..topology import list_topologies
    ap.add_argument("--topology", default=None,
                    choices=list_topologies(),
                    help="machine model (default: tree built from the "
                         "hierarchy/distance parameter strings)")
    ap.add_argument("--topology_params", default=None, metavar="JSON",
                    help="JSON object of constructor parameters for "
                         "--topology, e.g. '{\"dims\": [16, 16]}'")
    ap.add_argument("--distance_matrix_file", default=None,
                    help="explicit distance matrix (Metis graph with edge "
                         "weight = distance, .npy, or dense text); "
                         "implies --topology=matrix")
    ap.add_argument("--hierarchy_parameter_string")
    ap.add_argument("--distance_parameter_string")


def machine_flags_given(args) -> bool:
    """True when the invocation names a machine model explicitly (so it
    should override a machine carried inside a ``--config`` spec)."""
    return bool(args.topology or args.topology_params
                or args.distance_matrix_file
                or args.hierarchy_parameter_string
                or args.distance_parameter_string)


def _build(kind: str, params: dict):
    from ..topology import make_topology
    try:
        return make_topology(kind, **params)
    except TypeError as exc:
        # e.g. --topology=tree with partial --topology_params: surface the
        # factory's complaint as a user-facing CLI error, not a traceback
        raise ValueError(
            f"invalid parameters for topology {kind!r}: {exc}") from exc


def topology_from_args(args):
    """Build the machine model a CLI invocation asked for.

    Raises ``ValueError`` with a user-facing message on conflicting or
    missing flags."""
    params = {}
    if args.topology_params:
        params = json.loads(args.topology_params)
        if not isinstance(params, dict):
            raise ValueError("--topology_params must be a JSON object")
    if args.distance_matrix_file:
        if args.topology not in (None, "matrix"):
            raise ValueError("--distance_matrix_file implies "
                             f"--topology=matrix, not {args.topology!r}")
        params.setdefault("file", args.distance_matrix_file)
        return _build("matrix", params)
    kind = args.topology or "tree"
    if kind == "tree" and not params:
        if not args.hierarchy_parameter_string or \
                not args.distance_parameter_string:
            raise ValueError(
                "--hierarchy_parameter_string and "
                "--distance_parameter_string are required for the tree "
                "machine model (guide §4.1), or pick --topology=...")
        from ..core.hierarchy import Hierarchy
        from ..topology import TreeTopology
        return TreeTopology(hierarchy=Hierarchy.from_strings(
            args.hierarchy_parameter_string,
            args.distance_parameter_string))
    return _build(kind, params)
