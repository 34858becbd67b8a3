"""Profile the port's host construction (``hierarchytopdown``) on a 3-D
stencil under ``cProfile``.

    PYTHONPATH=src python3 tools/profile_construction.py \
        [--grid 16 16 8] [--hierarchy 4:16:32] [--distances 1:10:100] \
        [--top 12] [--src DIR]

Prints the construction's wall seconds and its functions by their own
time.  ``--src`` runs another checkout's ``src`` (for instance a parent
commit unpacked with ``git archive``) to compare two versions on one
host.  Host code only: no card is used.
"""

import argparse
import cProfile
import io
import pstats
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, nargs=3, default=(16, 16, 8))
    ap.add_argument("--hierarchy", default="4:16:32")
    ap.add_argument("--distances", default="1:10:100")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--src", default="src")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from repro_torch.core import Hierarchy, grid3d
    from repro_torch.core.construction import hierarchy_top_down
    from repro_torch.topology.base import as_topology
    topo = as_topology(Hierarchy.from_strings(args.hierarchy,
                                              args.distances))
    g = grid3d(*args.grid)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    hierarchy_top_down(g, topo, seed=0)
    prof.disable()
    wall = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
        args.top)
    print(f"n {g.n}  hierarchy {args.hierarchy}  construction "
          f"{wall:.3f} s under cProfile")
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
