"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell's system under test from the port (``repro_torch``),
warms up every shape its traffic uses, measures for ``--seconds``,
checks every answer against the plain reference, and prints one JSON
line: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics with the device's busy and idle time and a breakdown
(``--trace 1``).  The numbers compared for ``correct`` are printed
beside their limits as the last lines on standard error and under
``checks``, the last key of the line.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the port's sources beside this
directory, or when the JAX package or JAX was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the run lives at a fixed path inside the checkout, so
# only a checkout's first run builds; the port's CUDA libraries already
# build into <checkout>/build/repro_torch
_CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
# the host's numerics on a fixed number of threads, whatever the machine
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is the port)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"run.py: no port at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    bench = harness.load_benchmark(ROOT)
    cell = harness.load_cell(ROOT, bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    print(json.dumps(out["result"]), flush=True)
    print("\n".join(out["stderr"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
