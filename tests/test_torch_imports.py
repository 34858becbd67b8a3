"""The PyTorch/CUDA port imports neither jax nor any module of the JAX
package, nor ``ml_dtypes`` (the card's machine has none).  Checked in a
fresh interpreter, because this test process has all three loaded
already (tests/conftest.py imports jax)."""

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
                if k in ("jax", "repro", "ml_dtypes")
                or k.startswith(("jax.", "repro.", "ml_dtypes.")))
print(json.dumps({"modules": len(names), "names": names,
                  "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["modules"] >= 30        # every submodule was imported
    assert {"repro_torch.core.comm_model", "repro_torch.cli.evaluator",
            "repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.kernels.swap_gain",
            "repro_torch.kernels.flash_attention",
            "repro_torch.configs.base", "repro_torch.configs.granite_3_8b",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.rwkv", "repro_torch.train.steps",
            "repro_torch.launch.serve", "repro_torch.portfolio.kicks",
            "repro_torch.portfolio.search",
            "repro_torch.analysis.hlo", "repro_torch.analysis.roofline",
            "repro_torch.obs.metrics", "repro_torch.obs.export",
            "repro_torch.runtime.fault_tolerance",
            "repro_torch.monitor.loop", "repro_torch.cli.remap_watch",
            "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.dryrun",
            "repro_torch.models.sharding",
            "repro_torch.train.loss", "repro_torch.train.optimizer",
            "repro_torch.train.compression", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train",
            "repro_torch.staticcheck", "repro_torch.staticcheck.rules",
            "repro_torch.staticcheck.engine",
            "repro_torch.staticcheck.report",
            "repro_torch.staticcheck.runtime_audit",
            "repro_torch.staticcheck.__main__"} <= set(report["names"])
    assert report["leaked"] == [], f"repro_torch pulled in {report}"


def test_chip_smoke_imports_no_jax_and_no_repro():
    """``chip_smoke.py`` and the modules its phases import (the dry-run
    and sharding among them) leave jax and the JAX package out."""
    probe = """
import importlib, json, sys
sys.path.insert(0, %r)
import chip_smoke
for name in ("repro_torch.launch.dryrun", "repro_torch.models.sharding",
             "repro_torch.launch.train", "repro_torch.train.steps"):
    importlib.import_module(name)
print(json.dumps(sorted(k for k in sys.modules
                        if k in ("jax", "repro", "ml_dtypes")
                        or k.startswith(("jax.", "repro.", "ml_dtypes.")))))
""" % str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
