"""`generate_model` — build a model of computation and communication by
partitioning an application graph (guide §4.2)."""

from __future__ import annotations

import argparse

from ..core import read_metis, write_metis
from ..core.comm_model import generate_model


def main(argv=None):
    ap = argparse.ArgumentParser(prog="generate_model", description=__doc__)
    ap.add_argument("file", help="Graph to partition and build the model "
                                 "from.")
    ap.add_argument("--k", type=int, required=True,
                    help="Number of blocks, i.e. vertices in the model.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preconfiguration", default="eco",
                    choices=["strong", "eco", "fast", "fastsocial",
                             "ecosocial", "strongsocial"])
    ap.add_argument("--imbalance", type=float, default=3.0)
    ap.add_argument("--output_filename", default="model.graph")
    args = ap.parse_args(argv)

    g = read_metis(args.file)
    pre = args.preconfiguration.replace("social", "")  # social ≡ base here
    model, labels = generate_model(g, args.k, preconfiguration=pre,
                                   imbalance=args.imbalance / 100.0,
                                   seed=args.seed)
    write_metis(model, args.output_filename)
    print(f"partitioned n={g.n} m={g.num_edges} into k={args.k} blocks; "
          f"model has {model.num_edges} edges")
    print(f"wrote {args.output_filename}")


if __name__ == "__main__":
    main()
