"""Count, over many fresh processes, how often a process's first
``torch.cos`` on the CPU comes back wrong.

    python3 tools/cpu_first_cos.py [--procs 2000] [--jobs 8]
                                   [--mode default|warm|one-thread]

Each child computes the RoPE angles of the granite smoke prefill
(positions 0–95 of a batch of 2, hd 32, θ 1e4: a (2, 96, 16) float32
tensor, as ``repro_torch.models.layers.apply_rope`` makes them) and
then, in this order, ``torch.cos``, ``torch.sin`` and ``torch.cos``
again, each held against the float64 result rounded to float32.  A call
is wrong when it is off by more than 1e-6.  ``--mode warm`` runs
``repro_torch.testing.warm_cpu_math`` first, ``--mode one-thread`` sets
one intra-op thread first.  Prints one JSON line: how many children's
first cos, sin and second cos were wrong, the largest error of each,
and the batches a wrong first cos touched.  Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("default", "warm", "one-thread")
WRONG = 1e-6


def child(mode: str) -> dict:
    import torch
    if mode == "one-thread":
        torch.set_num_threads(1)
    from repro_torch.models.layers import rope_freqs
    if mode == "warm":
        from repro_torch.testing import warm_cpu_math
        warm_cpu_math()
    pos = torch.arange(96).expand(2, 96)
    ang = pos[..., None].to(torch.float32) * rope_freqs(32, 1e4)
    out = {}
    for name, fn in (("cos", torch.cos), ("sin", torch.sin),
                     ("cos_again", torch.cos)):
        err = (fn(ang) - fn(ang.double()).float()).abs()
        out[name] = float(err.max())
        if name == "cos":
            out["batches"] = sorted({int(b) for b in
                                     (err > WRONG).nonzero()[:, 0]})
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2000)
    ap.add_argument("--jobs", type=int, default=8,
                    help="children running at once")
    ap.add_argument("--mode", choices=MODES, default="default")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.child:
        print(json.dumps(child(args.mode)), flush=True)
        return 0
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           "--mode", args.mode]
    wrong = {"cos": 0, "sin": 0, "cos_again": 0}
    worst = dict.fromkeys(wrong, 0.0)
    batches: dict = {}
    failed = started = 0
    running: list = []
    while started < args.procs or running:
        while started < args.procs and len(running) < args.jobs:
            running.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.DEVNULL,
                                            text=True))
            started += 1
        proc = running.pop(0)
        out, _ = proc.communicate()
        if proc.returncode != 0 or not out.strip():
            failed += 1
            continue
        rec = json.loads(out.strip().splitlines()[-1])
        for name in wrong:
            wrong[name] += rec[name] > WRONG
            worst[name] = max(worst[name], rec[name])
        if rec["batches"]:
            key = str(rec["batches"])
            batches[key] = batches.get(key, 0) + 1
    print(json.dumps({"mode": args.mode, "procs": args.procs,
                      "failed": failed, "wrong": wrong, "worst": worst,
                      "first_cos_batches": batches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
