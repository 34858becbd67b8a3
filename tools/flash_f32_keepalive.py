"""Show on one CUDA card why K4's float32 kernel keeps its read of q's
small parts at the end of the tile loop (``csrc/flash_attention.cu``,
``if (window < 0)``).

    python3 tools/flash_f32_keepalive.py

It builds the float32 kernel twice with the library's own flags, into
``build/keepalive/`` (git-ignored): as the checkout has it, and with
that read taken out.  For each build it prints, per head dim:

- ``clobbered``: the writes that ``chip_smoke.clobbered_wgmma_operands``
  finds in the entry's SASS (``cuobjdump -sass``) to a register A
  operand of ``wgmma`` that the tile loop carries, and the first four
  of them (``first_writes``);
- ``max_abs_err``: the largest |kernel − reference| over causal and
  window-48 attention at T 64, 257 and 1000 (B 2, H 4, KV 2, randn
  inputs from seed 0), the reference in float64 on the card.

One JSON line, then the card's name and power limit (``nvidia-smi``).
Exits 1 if the build as checked out shows a clobbered operand or an
error above ``chip_smoke.FLASH_F32_TOL``.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

HEAD_DIMS = (32, 64, 96, 128)
# the keep-alive read: the block after the P·V of a trip
KEEPALIVE = re.compile(
    r"    if \(window < 0\) \{\n#pragma unroll\n.*?\n    \}\n", re.S)


def build(variants: dict, out: Path) -> dict:
    """{name: path of the built library} for {name: source text}, one
    ``nvcc`` each, all started together."""
    from repro_torch.kernels.cuda import _NVCC_FLAGS, _nvcc
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    procs = {}
    for name, text in variants.items():
        src = out / f"flash_attention_{name}.cu"
        src.write_text(text)
        lib = out / f"libflash_attention_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = lib
    return libs


def entries(lib: Path) -> dict:
    """{head dim: SASS lines} of the library's attention entries."""
    from chip_smoke import sass_functions
    return {int(m.group(1)): lines
            for f, lines in sass_functions(lib).items()
            for m in [re.search(r"flash_fwd_tf32ILi(\d+)E", f)] if m}


def reference(q, k, v, window):
    import torch
    t, hd = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    kd = k.double().repeat_interleave(g, dim=2)
    vd = v.double().repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.double(), kd) * hd ** -0.5
    i = torch.arange(t, device=q.device)
    vis = i[:, None] >= i[None, :]
    if window > 0:
        vis &= (i[:, None] - i[None, :]) < window
    p = torch.softmax(s.masked_fill(~vis, -1e30), -1)
    return torch.einsum("bhts,bshd->bthd", p, vd)


def max_errors(lib: Path) -> dict:
    """{head dim: max |kernel − reference|} over the cases above."""
    import torch
    so = ctypes.CDLL(str(lib))
    fn, size = so.viem_flash_attention, so.viem_flash_attention_scratch_floats
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i,
                   ctypes.c_float, p]
    fn.restype = i
    size.argtypes = [i] * 4
    size.restype = ctypes.c_longlong
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for hd in HEAD_DIMS:
        worst = 0.0
        for t in (64, 257, 1000):
            for window in (0, 48):
                b, h, kv = 2, 4, 2
                q, k, v = (torch.randn(b, t, n, hd, device="cuda",
                                       generator=gen) for n in (h, kv, kv))
                o = torch.empty_like(q)
                n = size(b, t, kv, hd)
                scratch = torch.empty(n, device="cuda")
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), scratch.data_ptr(), n, b, t, h, kv,
                        hd, window, hd ** -0.5 * math.log2(math.e),
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
                err = (o.double() - reference(q, k, v, window)).abs().max()
                worst = max(worst, float(err))
        out[hd] = worst
    return out


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.cuda import _nvcc
    if not torch.cuda.is_available():
        print("flash_f32_keepalive: no CUDA card", file=sys.stderr)
        return 2
    text = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    if len(KEEPALIVE.findall(text)) != 1:
        print("flash_f32_keepalive: the keep-alive read was not found",
              file=sys.stderr)
        return 2
    out = ROOT / "build" / "keepalive"
    out.mkdir(parents=True, exist_ok=True)
    libs = build({"as_built": text,
                  "no_keepalive": KEEPALIVE.sub("", text)}, out)
    report = {}
    for name, lib in libs.items():
        sass = entries(lib)
        found = {hd: chip_smoke.clobbered_wgmma_operands(sass[hd])
                 for hd in HEAD_DIMS}
        report[name] = {
            "clobbered": {hd: len(c) for hd, c in found.items()},
            "first_writes": {hd: c[:4] for hd, c in found.items() if c},
            "max_abs_err": max_errors(lib)}
    nvcc = subprocess.run([_nvcc(), "--version"],
                          capture_output=True, text=True).stdout
    report["nvcc"] = next((ln.strip() for ln in nvcc.splitlines()
                           if "release" in ln), "")
    report["tol"] = chip_smoke.FLASH_F32_TOL
    print(json.dumps(report), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    ok = report["as_built"]
    return 0 if (not any(ok["clobbered"].values()) and
                 max(ok["max_abs_err"].values()) <= report["tol"]) else 1


if __name__ == "__main__":
    sys.exit(main())
