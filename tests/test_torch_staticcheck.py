"""The port's invariant lint (`viem lint` of ``repro_torch.staticcheck``)
and its runtime audit, on the CPU.

Per-rule fixtures run the port's analyzer over small source snippets —
one with the hazard, one clean twin — so a rule regression fails here
before it floods a real module with findings.  The rules both packages
share (VIEM004, the ``# viem: noqa`` suppressions, the baseline
fingerprints) run the JAX package's cases through both engines as one
parametrised test.  The runtime audit runs every construction on the
five small machines (the JAX package's ``SMALL_TOPOLOGIES``) and flags a
seeded uncounted read and a seeded float64 intermediate.  Nothing here
uses the JAX package's jaxpr audit.
"""

from pathlib import Path

import pytest
import torch

import repro.staticcheck as ref_lint
import repro.staticcheck.engine as ref_engine
import repro_torch.staticcheck as port_lint
import repro_torch.staticcheck.engine as port_engine
from repro_torch.runtime.boundary import Boundary, host_boundary
from repro_torch.staticcheck.runtime_audit import (SMALL_TOPOLOGIES,
                                                   Recorder, audit_run,
                                                   run_audit)

ROOT = Path(__file__).resolve().parents[1]
DEV = "src/repro_torch/engine/snippet.py"      # device-package relpath
HOST = "src/repro_torch/cli/snippet.py"        # non-device relpath
LOCKED = "src/repro_torch/obs/metrics.py"      # lock-discipline module


def _rules(source, relpath=DEV):
    return [f.rule for f in port_lint.analyze_source(source, relpath)]


# ------------------------------------------------------------- VIEM001
# (hazard, clean twin): the twin reads through the scope's Boundary.read,
# or keeps the value on the device
SYNC_CASES = {
    "item": ("""\
import torch

def best(x):
    g = torch.max(x)
    return g.item()
""", """\
import torch

def best(x, hb):
    g = torch.max(x)
    return hb.read(g)
"""),
    "cpu": ("""\
import torch

def perm_back(x):
    p = torch.argsort(x)
    return p.cpu()
""", """\
import torch

def perm_back(x, hb):
    p = torch.argsort(x)
    return hb.read(p)
"""),
    "bool": ("""\
import torch

def any_live(x):
    live = torch.gt(x, 0)
    return bool(live.any())
""", """\
import torch

def any_live(x, hb):
    live = torch.gt(x, 0)
    return bool(hb.read(live.any()))
"""),
    "mask-index": ("""\
import torch

def positive(x):
    g = torch.abs(x) - 1.0
    keep = g > 0
    return g[keep]
""", """\
import torch

def positive(x):
    g = torch.abs(x) - 1.0
    return torch.where(g > 0, g, 0.0)
"""),
    "nonzero": ("""\
import torch

def where_live(x):
    live = torch.gt(x, 0)
    return torch.nonzero(live)
""", """\
import torch

def where_live(x):
    live = torch.gt(x, 0)
    return torch.where(live, x, 0)
"""),
    "where-one-arg": ("""\
import torch

def where_live(x):
    return torch.where(torch.gt(x, 0))
""", """\
import torch

def where_live(x):
    return torch.where(torch.gt(x, 0), 1, 0)
"""),
    "timing": ("""\
import time
import torch

def sweep(x):
    t0 = time.perf_counter()
    y = torch.cumsum(x, 0)
    return y, time.perf_counter() - t0
""", """\
import torch

def sweep(x):
    return torch.cumsum(x, 0)
"""),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_viem001_flags_hazard_and_passes_twin(case):
    hazard, clean = SYNC_CASES[case]
    assert "VIEM001" in _rules(hazard)
    assert "VIEM001" not in _rules(clean)


def test_viem001_only_in_device_packages():
    assert _rules(SYNC_CASES["item"][0], relpath=HOST) == []


def test_viem001_exempts_boundary_read():
    """The body of ``Boundary.read`` is the one place a tensor is read
    back (``runtime/boundary.py``: the rule applies to it only when it
    sits in a device package, as here)."""
    src = ("class Boundary:\n"
           "    def read(self, t):\n"
           "        self.reads += 1\n"
           "        return t.item() if t.dim() == 0 else "
           "t.cpu().numpy()\n"
           "\n"
           "def other(t):\n"
           "    return t.cpu().numpy()\n")
    found = port_lint.analyze_source(src, DEV)
    assert [(f.rule, f.line) for f in found] == [("VIEM001", 7)]


def test_viem001_static_attrs_and_numpy_are_not_reads():
    src = ("import numpy as np\n"
           "import torch\n"
           "def f(x, w):\n"
           "    n = torch.abs(x).shape[0]\n"
           "    c = np.float32(w).item()\n"
           "    return float(n) * c, np.arange(3).tolist()\n")
    assert _rules(src) == []


# ------------------------------------------------------------- VIEM003
CONTROL_TRIGGER = """\
import torch

def refine(x):
    live = torch.gt(x, 0)
    if live.any():
        return x
    return -x
"""

CONTROL_CLEAN = """\
import torch

def refine(x, hb):
    live = torch.gt(x, 0)
    if hb.read(live.any()):
        return x
    return -x
"""


def test_viem003_flags_python_branch_on_tensor():
    assert "VIEM003" in _rules(CONTROL_TRIGGER)
    assert "VIEM003" in _rules(CONTROL_TRIGGER.replace(
        "    if live.any():\n        return x\n",
        "    while live.any():\n        live = live & False\n"))
    assert "VIEM003" in _rules(CONTROL_TRIGGER.replace(
        "    if live.any():\n        return x\n",
        "    assert live.all()\n"))


def test_viem003_accepts_a_counted_read_and_static_tests():
    assert "VIEM003" not in _rules(CONTROL_CLEAN)
    src = ("import torch\n"
           "def f(x, kind):\n"
           "    y = torch.abs(x)\n"
           "    if kind == 'matrix' or y.shape[0] > 2 or y is None:\n"
           "        return y\n"
           "    return -y\n")
    assert _rules(src) == []


# ---------------------------------------------- rules both engines share
LOCK_TRIGGER = """\
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def inc(self):
        with self._lock:
            self.total += 1

    def read(self):
        return self.total
"""

LOCK_CLEAN = LOCK_TRIGGER.replace(
    "        return self.total",
    "        with self._lock:\n            return self.total")

ENGINES = {
    "repro": (ref_lint, ref_engine, "src/repro/obs/metrics.py"),
    "repro_torch": (port_lint, port_engine, LOCKED),
}


def _shared_case(case, lint, engine, locked):
    if case == "viem004-flags-unguarded-read":
        assert "VIEM004" in [f.rule for f in
                             lint.analyze_source(LOCK_TRIGGER, locked)]
    elif case == "viem004-accepts-guarded-read":
        assert "VIEM004" not in [f.rule for f in
                                 lint.analyze_source(LOCK_CLEAN, locked)]
    elif case == "viem004-scoped-to-lock-modules":
        assert "VIEM004" not in [f.rule for f in lint.analyze_source(
            LOCK_TRIGGER, locked.replace("obs/metrics", "cli/snippet"))]
    elif case == "noqa-suppresses-with-justification":
        src = LOCK_TRIGGER.replace(
            "        return self.total",
            "        return self.total  "
            "# viem: noqa[VIEM004] a torn read is fine for this gauge")
        findings = engine.lint_source(src, locked)
        assert findings and all(f.suppressed for f in findings)
        assert all(f.justification for f in findings)
    elif case == "noqa-other-rule-does-not-suppress":
        src = LOCK_TRIGGER.replace(
            "        return self.total",
            "        return self.total  # viem: noqa[VIEM003] wrong rule")
        findings = engine.lint_source(src, locked)
        assert any(f.rule == "VIEM004" and not f.suppressed
                   for f in findings)
    elif case == "noqa-without-justification-is-unjustified":
        src = LOCK_TRIGGER.replace(
            "        return self.total",
            "        return self.total  # viem: noqa[VIEM004]")
        findings = engine.lint_source(src, locked)
        result = engine.LintResult(findings=findings)
        assert result.unjustified and not result.active
    elif case == "baseline-fingerprint-suppresses":
        clean = engine.lint_source(LOCK_TRIGGER, locked)
        fps = {f.fingerprint() for f in clean}
        based = engine.lint_source(LOCK_TRIGGER, locked, baseline=fps)
        assert based and all(f.suppressed for f in based)
        assert all(f.justification == "baselined" for f in based)
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "viem004-flags-unguarded-read", "viem004-accepts-guarded-read",
    "viem004-scoped-to-lock-modules", "noqa-suppresses-with-justification",
    "noqa-other-rule-does-not-suppress",
    "noqa-without-justification-is-unjustified",
    "baseline-fingerprint-suppresses"])
@pytest.mark.parametrize("package", sorted(ENGINES))
def test_shared_rules_in_both_engines(package, case):
    _shared_case(case, *ENGINES[package])


def test_port_lock_modules_cover_its_threaded_classes():
    """Every port module whose class keeps ``self._lock`` is in VIEM004's
    scope (core/pinned.py beside the JAX package's list)."""
    import re

    from repro_torch.staticcheck.rules import _in_lock_module
    src = ROOT / "src" / "repro_torch"
    holders = sorted(p.relative_to(src).as_posix()
                     for p in src.rglob("*.py")
                     if re.search(r"self\._?lock\s*=", p.read_text()))
    assert holders, "no lock-holding class found"
    assert all(_in_lock_module(h) for h in holders), holders


# ------------------------------------------------------------ the tree
def test_port_is_lint_clean():
    """src/repro_torch has zero unsuppressed findings and every
    suppression carries its justification; the port's baseline is
    empty."""
    result = port_lint.lint_paths(
        port_lint.LintConfig(baseline=port_engine.DEFAULT_BASELINE),
        root=ROOT)
    assert result.files_checked > 90
    assert result.active == [], [f.fingerprint() for f in result.active]
    assert result.unjustified == []
    assert port_lint.load_baseline(ROOT / port_engine.DEFAULT_BASELINE) \
        == set()


def test_cli_reports_json_and_exits_clean(tmp_path, capsys):
    import json

    from repro_torch.staticcheck.__main__ import main
    out = tmp_path / "lint.json"
    assert main(["--root", str(ROOT), "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["active"] == [] and doc["files_checked"] > 90
    assert set(doc["rules"]) >= {"VIEM001", "VIEM003", "VIEM004"}
    assert "0 active finding(s)" in capsys.readouterr().out


def test_cli_fails_on_a_finding(tmp_path, capsys):
    from repro_torch.staticcheck.__main__ import main
    pkg = tmp_path / "src" / "repro_torch" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(SYNC_CASES["item"][0])
    assert main(["--root", str(tmp_path)]) == 1
    assert "VIEM001" in capsys.readouterr().out


# ------------------------------------------------------ runtime audit
@pytest.mark.parametrize("topology", sorted(SMALL_TOPOLOGIES))
def test_runtime_audit_topology_lane(topology):
    report = run_audit(topologies=[topology], device="cpu")
    assert report["device"] == "cpu"
    assert report["ok"], [e for e in report["entries"]
                          if e["status"] == "failed"]
    ok = [e for e in report["entries"] if e["status"] == "ok"]
    assert ok, report["entries"]    # at least one construction ran
    skipped = {e["construction"] for e in report["entries"]
               if e["status"] == "skipped"}
    assert skipped <= {"hierarchybottomup"}


def _reads(counted: bool):
    with host_boundary("audit.seeded") as hb:
        t = torch.arange(4.0).sum()
        return hb.read(t) if counted else t.item()


def test_runtime_audit_flags_an_uncounted_read():
    assert audit_run(lambda: _reads(True)) == []
    problems = audit_run(lambda: _reads(False))
    assert any("_local_scalar_dense outside Boundary.read (audit.seeded)"
               in p for p in problems), problems


def test_runtime_audit_flags_a_float64_intermediate():
    assert audit_run(lambda: torch.ones(3).cumsum(0)) == []
    problems = audit_run(lambda: torch.ones(3, dtype=torch.float64) * 2)
    assert any("float64" in p for p in problems), problems
    assert audit_run(lambda: torch.ones(3, dtype=torch.float64) * 2,
                     acc_dtype="float64") == []


def test_runtime_audit_flags_a_copy_inside_a_counted_scope():
    """A copy between devices inside a counted scope (faked here with a
    scope whose syncs are counted, and the meta device) is a problem
    unless a read or a ``*.upload`` scope makes it."""
    def run(tag):
        rec = Recorder("float32")
        b = Boundary(tag)
        b.syncs = 0
        rec.opened(b)
        with rec:
            torch.ones(3).to("meta")
        return rec.problems
    assert any("between devices" in p for p in run("engine.sweeps"))
    assert run("engine.upload") == set()


def test_runtime_audit_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_audit(device="cuda")


def test_runtime_audit_counts_the_cards_syncs(monkeypatch):
    """The audit's card side with PyTorch's sync debug mode stubbed (as
    tests/test_torch_boundary.py does) and each sync raised by hand as
    the warning PyTorch gives: a sync in a read or a named upload
    passes, one elsewhere is a problem, a CUDA scope whose syncs exceed
    its reads is one, and the debug mode's one-time notice is no sync."""
    import warnings

    state = [0]
    names = {"default": 0, "warn": 1, "error": 2}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: state.__setitem__(0, names.get(m, m)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def sync():
        warnings.warn("called a synchronizing CUDA operation", UserWarning)

    class Read:
        """A 0-d tensor whose readback syncs once, as on a card."""

        def dim(self):
            return 0

        def item(self):
            sync()
            return torch.ones(()).item()

    def clean():
        warnings.warn("Synchronization debug mode is a prototype feature "
                      "and does not yet detect all synchronizing "
                      "operations", UserWarning)
        with host_boundary("x.upload"):
            sync()
        with host_boundary("x.loop", "cuda") as hb:
            hb.read(Read())
        with host_boundary("x.readback") as rb:
            rb.read(Read())

    def stray():
        with host_boundary("x.readback"):
            sync()

    def loop():
        with host_boundary("x.loop", "cuda") as hb:
            sync()
            hb.read(Read())

    with warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        assert audit_run(clean, device="cuda") == []
        assert any("outside Boundary.read and the named uploads "
                   "(x.readback)" in p
                   for p in audit_run(stray, device="cuda"))
        assert any("scope x.loop: 2 syncs observed against 1 counted"
                   in p for p in audit_run(loop, device="cuda"))
    # the notice went on to the caller; no sync did
    assert [str(w.message)[:31] for w in passed] == [
        "Synchronization debug mode is a"]
    assert state[0] == 0                        # the mode is restored
