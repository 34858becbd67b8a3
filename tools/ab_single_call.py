"""Time the port's single (one-lane) calls on one CUDA card, for an A/B
of two checkouts in one machine session.

    python3 tools/ab_single_call.py [--src DIR] [--reps 5]
                                    [--parts k2,torus,k4f32,prefill]

``--src`` is the ``src`` directory of the checkout to time (default:
this checkout's); the port's kernels are built into that checkout's
``build/``.  ``--parts`` picks what to time (default ``k2,torus``).  It
prints one JSON line:

- ``k2_tree_ms``: K2's device time per launch in the tree form at the
  main path's shape (4:16:64 / 1:10:100, the 16³ stencil, the
  communication pairs at distance 10: P = 1,824,720, K = 8), 100
  launches back to back behind a spin kernel, so the CUDA events bracket
  the kernels alone (as ``chip_smoke.py``'s ``device_ms``);
- ``torus_refine_seconds``: the refinement seconds of ``Mapper.map`` on
  the torus form at n = 1024 (``TorusTopology((16, 16, 4))``,
  ``grid3d(16, 16, 4)``: 64 sweeps, the map whose refinement is the
  longest of the single maps), each of ``--reps`` maps after a first one
  that builds the kernels, the engine's ``refine`` bracketed by
  synchronizes;
- ``k4_f32_ms`` (part ``k4f32``): K4's float32 route at
  ``chip_smoke.FLASH_SHAPES``' float32 shapes (``serve-f32``: B 4, T
  2048, 32/8 heads, hd 128, causal; ``window-f32``: B 1, T 8192, 36/4
  heads, hd 128, window 4096), randn inputs from seed 2, milliseconds a
  call over back-to-back calls (CUDA events, as ``chip_smoke.cuda_ms``),
  ``--reps`` readings each;
- ``prefill_s`` (part ``prefill``): granite-3-8b's prefill at
  ``chip_smoke.SERVE``'s shape (B 4 × 2048 prompt tokens, bf16, random
  weights and prompts from seed 0, the serve cell's), wall seconds of
  ``prefill_with_cache`` between synchronizes, ``--reps`` readings after
  one warm-up call;
- the card's name and power limit (``nvidia-smi``).

Compare two checkouts only within one session: run A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def device_ms(fn, iters: int = 100) -> float:
    import torch
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * host_s + 1e-3) * 2.0e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_tree_ms() -> float:
    import numpy as np
    import torch

    from repro_torch.core import DeviceGraph, Hierarchy, device_pairs, grid3d
    from repro_torch.core.local_search import communication_pairs
    from repro_torch.kernels import pair_gains
    from repro_torch.topology.base import as_topology
    topo = as_topology(Hierarchy.from_strings("4:16:64", "1:10:100"))
    kp = topo.kernel_params()
    g = grid3d(16, 16, 16)
    dev = torch.device("cuda")
    dg = DeviceGraph.from_comm(g, device=dev)
    us, vs = device_pairs(communication_pairs(g, 10), device=dev)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(g.n)
                            .astype(np.int32)).to(dev)
    D = torch.zeros((1, 1), device=dev)
    return device_ms(lambda: pair_gains(kp[0], kp[1:], dg.nbr, dg.wgt, perm,
                                        us, vs, D))


def torus_refine_seconds(reps: int) -> list:
    import torch

    from repro_torch.core import Mapper, MappingSpec, grid3d
    from repro_torch.topology import TorusTopology
    g = grid3d(16, 16, 4)
    mapper = Mapper(TorusTopology((16, 16, 4)),
                    MappingSpec(engine="device", backend="pallas"),
                    device="cuda")
    eng = mapper.lower_for(g).engines[0]
    orig, secs = eng.refine, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out
    eng.refine = timed
    for _ in range(reps + 1):
        mapper.map(g)
    return secs[1:]


def k4_f32_ms(reps: int) -> dict:
    import torch

    from chip_smoke import FLASH_SHAPES, cuda_ms
    from repro_torch.kernels import FLASH_F32_KERNEL, flash_attention_kernel
    out = {}
    for name in ("serve-f32", "window-f32"):
        (b, t, h, kv, hd, window), _ = FLASH_SHAPES[name]
        gen = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = (torch.randn((b, t, n, hd), generator=gen, device="cuda")
                   for n in (h, kv, kv))
        before = FLASH_F32_KERNEL.launches
        out[name] = [cuda_ms(lambda: flash_attention_kernel(
            q, k, v, window=window), iters=10, warmup=2)
            for _ in range(reps)]
        if FLASH_F32_KERNEL.launches == before:
            raise RuntimeError("K4's float32 route did not launch")
        del q, k, v
        torch.cuda.empty_cache()
    return out


def prefill_s(reps: int) -> list:
    import torch

    from chip_smoke import SERVE
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    cfg = get_config(SERVE["arch"])
    max_len = SERVE["prompt_len"] + SERVE["gen"]
    out = []
    with torch.inference_mode():
        params = init_params(SERVE["seed"], cfg, device="cuda")
        prompts = make_prompts(cfg, SERVE["batch"], SERVE["prompt_len"],
                               SERVE["seed"], "cuda")
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill_with_cache(params, prompts, cfg, max_len)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    del params, prompts
    torch.cuda.empty_cache()
    return out[1:]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parts", default="k2,torus")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke  # noqa: F401  (puts this checkout's src on the path)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    import repro_torch
    out = {"src": args.src, "module": repro_torch.__file__, "card": card}
    if "torus" in parts:
        out["torus_refine_seconds"] = torus_refine_seconds(args.reps)
    if "k2" in parts:
        out["k2_tree_ms"] = k2_tree_ms()
    if "k4f32" in parts:
        out["k4_f32_ms"] = k4_f32_ms(args.reps)
    if "prefill" in parts:
        out["prefill_s"] = prefill_s(args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
