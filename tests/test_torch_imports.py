"""The PyTorch/CUDA port imports neither jax nor any module of the JAX
package.  Checked in a fresh interpreter, because this test process has
both loaded already (tests/conftest.py imports jax)."""

import json
import os
import subprocess
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[1] / "src")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print(json.dumps({"modules": len(names), "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["modules"] >= 25        # every submodule was imported
    assert report["leaked"] == [], f"repro_torch pulled in {report}"
