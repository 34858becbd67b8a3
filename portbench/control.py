"""Readings for the limits of ``correct``: the program's numbers and the
control's on many seeds in one process, or a planted fault's.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--fault unchanged|half_batch|altered]

For each seed the cell is set up again for that seed (the program's
plans, pair sets and compiled kernels are kept), measured for
``--seconds`` at the cell's own load, and judged twice: on the
program's answers, and with the control in the program's place (the
reference one precision step below the configuration's).  One JSON line
per seed.  With ``--fault`` the fault is planted for the whole process
and the line holds its readings.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, driver, seed: int, seconds: float) -> dict:
    from portbench import harness
    traffic = harness.kind_of(cell).Traffic(cell.traffic, seed)
    driver.setup(traffic, seed)
    window = driver.window(traffic, seconds)
    prog = harness.judge_window(cell, window, traffic, seed)
    ctrl = harness.judge_window(cell, window, traffic, seed, control=True)
    return {"seed": seed, "attempted": prog.attempted,
            "failed": prog.failed, "correct": prog.correct,
            "program": prog.values, "control": ctrl.values,
            "control_correct": ctrl.correct, "j_rel": prog.j_rel,
            "notes": prog.notes, "setup": driver.phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import contextlib

    from portbench import faults, harness
    cell = harness.load_cell(ROOT, harness.load_benchmark(ROOT),
                             args.workload)
    plant = (faults.plant(args.fault) if args.fault
             else contextlib.nullcontext())
    with plant:
        driver = harness.kind_of(cell).Driver(cell.config, cell.traffic,
                                              args.device)
        try:
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                out = readings(cell, driver, seed, args.seconds)
                out.update(fault=args.fault,
                           seconds=time.perf_counter() - t0)
                print(json.dumps(out), flush=True)
        finally:
            driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
