"""`graphchecker` — validate the Metis graph format (guide §4.3)."""

from __future__ import annotations

import argparse
import sys

from ..core import GraphFormatError, read_metis


def main(argv=None):
    ap = argparse.ArgumentParser(prog="graphchecker", description=__doc__)
    ap.add_argument("file", help="Path to the graph file.")
    args = ap.parse_args(argv)
    try:
        g = read_metis(args.file)
    except GraphFormatError as e:
        print(f"The graph format seems to be corrupt:\n  {e}")
        sys.exit(1)
    print(f"The graph format seems correct. (n={g.n}, m={g.num_edges})")


if __name__ == "__main__":
    main()
