"""Repeat K4's float32 route, at the shape of the granite smoke prefill,
in many fresh processes on one CUDA card, each launch against the plain
version.

    python3 tools/flash_f32_repeat.py [--procs 24] [--launches 64]
                                      [--cold-cpu] [--src DIR] [--out FILE]

The shape is the one ``tests/test_torch_card.py::
test_prefill_on_card_equals_cpu[float32]`` gives K4: the granite-3-8b
smoke config (2 layers, d 128, 4 heads, 2 KV heads, hd 32) at B 2, T 96,
float32, causal: q (2, 96, 4, 32), k and v (2, 96, 2, 32).  Each 128-row
q block then walks 3 kv tiles of 32 keys through the kernel's 2-stage
ring, so the ring's refill runs (tile 2 into stage 0), and the second
warpgroup (rows 64–127, of them 64–95 real) computes a tile the first
skips.

``--procs`` child processes run one after another (``--child``), each
from a cold start, in turn in three variants: ``default``, ``busy``
(another stream kept busy with float32 matrix products while K4 runs)
and ``blocking`` (``CUDA_LAUNCH_BLOCKING=1``).  A child runs, in order:

1. ``cold``: the process's first K4 launch, at the shape;
2. ``prefill``: the smoke prefill on the card, logits against the same
   prefill on the CPU (the card test's 1e-4), first as the test runs it,
   then again with every K4 launch held against ``flash_attention_plain``
   on the same card inputs (one record a layer) and each layer's q, k, v
   and attention output against the CPU's, then with the plain version
   in K4's place; float64 digests of the CPU and card tensors (equal
   across processes where the tensors are) and the process's TF32 flags;
3. ``repeat``: ``--launches`` launches at the shape, each on fresh seeded
   randn inputs, each against the plain version.

Before the prefill a child runs the CPU's vector math once
(``repro_torch.testing.warm_cpu_math``), as the card tests and
``chip_smoke.py`` do before their CPU references; ``--cold-cpu`` leaves
that out, and then a process's first multi-threaded ``torch.cos`` (the
CPU prefill's RoPE of layer 0's q) may come back ~1.5e-4 off and the
logits 6.2e-4 from the card's: the prefill's digests show it on the CPU
side.

A launch is bad when max |kernel − plain| > ``chip_smoke.FLASH_F32_TOL``
(2e-5).  For the worst launch the child reports the first query row whose
error passes the tolerance and the kv tile it starts at (row // 32: rows
of tile j are the first to see keys of tile j), its q block, warpgroup
and warp.  The parent prints one JSON line a child, then a summary line
(worst |Δ|, bad launches per variant, the tiles where errors start, bad
prefills, how many children gave each CPU and each card logits digest)
and the card's name and power limit (``nvidia-smi``), and exits
1 if any launch or prefill was bad or a child failed.  ``--out`` also
writes every child's full record (JSON lines).  ``--src`` is the ``src``
directory of another checkout to run instead (its kernels are built into
that checkout's ``build/``); compare two checkouts within one session.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2, 96, 4, 2, 32)           # b, t, h, kv, hd; window 0
KV_TILE = 32                         # keys of the float32 route's kv tile
VARIANTS = ("default", "busy", "blocking")
PREFILL_TOL = 1e-4                   # the card test's limit on the logits


def _worst(got, want, tol: float) -> dict:
    """max |got − want| and, where it passes ``tol``, the first bad row
    (t) with its kv tile, q block, warpgroup and warp, and the bad
    (batch, head) pairs."""
    diff = (got.float() - want.float()).abs()          # (B, T, H, hd)
    rec = {"max_abs_err": float(diff.max())}
    if rec["max_abs_err"] > tol:
        rows = (diff.amax(dim=(0, 2, 3)) > tol).nonzero().flatten()
        row = int(rows[0])
        heads = (diff.amax(dim=(1, 3)) > tol).nonzero().tolist()
        rec.update(first_bad_row=row, bad_rows=len(rows),
                   start_tile=row // KV_TILE, q_block=row // 128,
                   warpgroup=row % 128 // 64, warp=row % 64 // 16,
                   bad_batch_heads=heads)
    return rec


def _inputs(gen, device):
    import torch
    b, t, h, kv, hd = SHAPE
    return tuple(torch.randn((b, t, n, hd), generator=gen, device=device)
                 for n in (h, kv, kv))


def _tf32_flags() -> dict:
    import torch
    flags = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision":
                 torch.get_float32_matmul_precision()}
    prec = getattr(torch.backends.cuda.matmul, "fp32_precision", None)
    if prec is not None:
        flags["matmul_fp32_precision"] = prec
    return flags


def _digest(t) -> float:
    """A float64 sum of a tensor: equal across processes when the tensor
    is."""
    return float(t.double().sum())


def _prefill(tol: float, device) -> dict:
    """The card test's prefill; then the same with every K4 launch held
    against the plain version on its own card inputs, and each layer's
    q, k, v and attention output against the CPU prefill's; then the
    card prefill with the plain version in K4's place.  Digests of the
    CPU and card tensors tell a process whose CPU side differs from one
    whose card side does."""
    import dataclasses

    import repro_torch.models.attention as attention
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.transformer import (init_params,
                                                prefill_with_cache)
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              dtype="float32")
    kernel = attention.flash_attention_kernel

    def run(params, toks, attend=kernel, held=False):
        """Logits and each layer's (q, k, v, o), and the held K4 errors."""
        layers, errs = [], []

        def hook(q, k, v, *, window=0):
            o = attend(q, k, v, window=window)
            layers.append(tuple(x.detach().clone() for x in (q, k, v, o)))
            if held:
                errs.append(_worst(o, flash_attention_plain(
                    q, k, v, window=window), tol))
            return o
        attention.flash_attention_kernel = hook
        try:
            logits, _ = prefill_with_cache(params, toks, cfg, 100)
        finally:
            attention.flash_attention_kernel = kernel
        return logits[..., :cfg.vocab_size], layers, errs

    def err(a, b) -> float:
        return float((a.cpu() - b.cpu()).abs().max())

    params = init_params(0, cfg, device="cpu")
    toks = make_prompts(cfg, 2, 96, 0, "cpu")
    want, cpu_layers, _ = run(params, toks)
    dev_params, dev_toks = params.to(device), toks.to(device)
    as_test, _ = prefill_with_cache(dev_params, dev_toks, cfg, 100)
    got, card_layers, held = run(dev_params, dev_toks, held=True)
    plain, _, _ = run(dev_params, dev_toks, attend=flash_attention_plain)
    rec = {"flags": _tf32_flags(),
           "logits_err": err(as_test[..., :cfg.vocab_size], want),
           "logits_err_held": err(got, want),
           "logits_err_plain": err(plain, want),
           "logits_k4_vs_plain": err(got, plain),
           "layers": held,
           "vs_cpu": [{n: err(a, b) for n, a, b in zip("qkvo", c, g)}
                      for c, g in zip(cpu_layers, card_layers)],
           "digests": {side: {"logits": _digest(lg),
                              "layers": [[_digest(x) for x in layer]
                                         for layer in ls]}
                       for side, lg, ls in (("cpu", want, cpu_layers),
                                            ("card", got, card_layers))}}
    rec["bad"] = (max(rec["logits_err"], rec["logits_err_held"])
                  > PREFILL_TOL
                  or any(r["max_abs_err"] > tol for r in held))
    return rec


def child(variant: str, launches: int, seed: int, tol: float,
          device="cuda", warm: bool = True) -> dict:
    import torch

    import repro_torch
    from repro_torch.kernels import FLASH_F32_KERNEL, flash_attention_kernel
    from repro_torch.kernels.ref import flash_attention_plain
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"variant": variant, "seed": seed,
           "module": repro_torch.__file__,
           "launch_blocking": os.environ.get("CUDA_LAUNCH_BLOCKING")}
    q, k, v = _inputs(gen, device)
    out["cold"] = _worst(flash_attention_kernel(q, k, v),
                         flash_attention_plain(q, k, v), tol)
    if warm:
        from repro_torch.testing import warm_cpu_math
        warm_cpu_math()
    out["warm_cpu"] = warm
    out["prefill"] = _prefill(tol, device)

    if variant == "busy":
        side = torch.cuda.Stream(device=device)
        a = torch.randn((2048, 2048), device=device)
    bad, worst, records = 0, {"max_abs_err": 0.0}, []
    before = FLASH_F32_KERNEL.launches
    for _ in range(launches):
        q, k, v = _inputs(gen, device)
        if variant == "busy":
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(8):
                    a = a @ a
                    a = a / a.abs().amax()
        got = flash_attention_kernel(q, k, v)
        rec = _worst(got, flash_attention_plain(q, k, v), tol)
        records.append(rec["max_abs_err"])
        if rec["max_abs_err"] > tol:
            bad += 1
        if rec["max_abs_err"] >= worst["max_abs_err"]:
            worst = rec
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["repeat"] = {"launches": FLASH_F32_KERNEL.launches - before,
                     "bad": bad, "worst": worst, "errors": records}
    return out


def _run_child(i: int, args, src: str, sink, summary: dict) -> None:
    """Run child ``i`` and fold its record into ``summary``."""
    from chip_smoke import FLASH_F32_TOL
    variant = VARIANTS[i % len(VARIANTS)]
    env = dict(os.environ)
    env.pop("CUDA_LAUNCH_BLOCKING", None)
    if variant == "blocking":
        env["CUDA_LAUNCH_BLOCKING"] = "1"
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           variant, "--seed", str(i), "--launches", str(args.launches),
           "--src", src] + (["--cold-cpu"] if args.cold_cpu else [])
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=args.timeout)
        lines = proc.stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if proc.returncode == 0 and lines \
            else None
        err = proc.stderr.strip()[-2000:]
    except subprocess.TimeoutExpired:
        rec, err = None, f"timed out after {args.timeout} s"
    if rec is None:
        summary["failed_children"] += 1
        print(json.dumps({"child": i, "variant": variant,
                          "failed": err}), flush=True)
        return
    if sink:
        sink.write(json.dumps(dict(rec, child=i)) + "\n")
    bad = rec["repeat"]["bad"] + (rec["cold"]["max_abs_err"] >
                                  FLASH_F32_TOL)
    summary["bad"][variant] += bad
    summary["launched"][variant] += rec["repeat"]["launches"] + 1
    summary["bad_prefills"] += rec["prefill"]["bad"]
    for side, count in summary["logits_digests"].items():
        key = repr(rec["prefill"]["digests"][side]["logits"])
        count[key] = count.get(key, 0) + 1
    worst = max([rec["cold"]["max_abs_err"],
                 rec["repeat"]["worst"]["max_abs_err"]] +
                [r["max_abs_err"] for r in rec["prefill"]["layers"]])
    summary["worst"] = max(summary["worst"], worst)
    for r in [rec["cold"], rec["repeat"]["worst"],
              *rec["prefill"]["layers"]]:
        if "start_tile" in r:
            key = str(r["start_tile"])
            summary["start_tiles"][key] = \
                summary["start_tiles"].get(key, 0) + 1
    pre = rec["prefill"]
    print(json.dumps({
        "child": i, "variant": variant, "cold": rec["cold"],
        "repeat_bad": rec["repeat"]["bad"],
        "repeat_worst": rec["repeat"]["worst"],
        "prefill_logits_err": [pre["logits_err"],
                               pre["logits_err_held"],
                               pre["logits_err_plain"]],
        "digests": [pre["digests"]["cpu"]["logits"],
                    pre["digests"]["card"]["logits"]],
        "prefill_k4_err": [r["max_abs_err"] for r in pre["layers"]],
        "flags": pre["flags"]}), flush=True)


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=24)
    ap.add_argument("--launches", type=int, default=64)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--cold-cpu", action="store_true",
                    help="leave out the CPU vector-math warm-up before "
                         "the CPU prefill")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a child may take")
    ap.add_argument("--child", choices=VARIANTS, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLASH_F32_TOL
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_repeat: no CUDA card", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args.launches, args.seed,
                               FLASH_F32_TOL, warm=not args.cold_cpu)),
              flush=True)
        return 0

    card = _card()
    summary = {"src": src, "procs": args.procs, "launches": args.launches,
               "warm_cpu": not args.cold_cpu,
               "tol": FLASH_F32_TOL, "worst": 0.0, "failed_children": 0,
               "bad_prefills": 0, "start_tiles": {},
               "logits_digests": {"cpu": {}, "card": {}},
               "bad": {v: 0 for v in VARIANTS},
               "launched": {v: 0 for v in VARIANTS}}
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(open(args.out, "a")) if args.out \
            else None
        for i in range(args.procs):
            _run_child(i, args, src, sink, summary)
    summary["seconds"] = time.perf_counter() - t0
    summary["card"] = card
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    ok = (summary["failed_children"] == 0 and summary["bad_prefills"] == 0
          and not any(summary["bad"].values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
