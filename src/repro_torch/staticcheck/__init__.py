"""Invariant lint engine for the port (`viem lint`).

The port keeps three disciplines that a generic linter cannot see: every
host sync of a device path is a named, counted read (``Boundary.read``
inside a ``host_boundary`` scope), device code branches on the card and
not on the host, and threaded serving/monitoring classes touch their
shared state under their lock.  This package encodes them as
repo-specific checks, as the JAX package's ``repro.staticcheck`` does
for its own:

- an AST rule engine (:mod:`repro_torch.staticcheck.rules`) with three
  rules: VIEM001 host-sync hazards in device packages, VIEM003 Python
  control flow on tensors, VIEM004 lock discipline on threaded classes
  (VIEM002, the JAX package's retrace rule, is reserved: the port
  compiles nothing per call);
- a runtime audit (:mod:`repro_torch.staticcheck.runtime_audit`), the
  eager counterpart of the jaxpr audit: it runs every registered
  construction x topology through the plan's ``execute``,
  ``execute_batch`` and the portfolio's shared-graph lanes under a
  ``TorchDispatchMode`` that records every aten op, and holds the run to
  counted reads only, no copy between devices inside a counted loop, and
  no floating intermediate off the plan's accumulator dtype;
- a CLI (``python -m repro_torch.staticcheck`` / ``viem lint``) emitting
  human and JSON reports, with ``# viem: noqa[VIEMxxx]`` inline
  suppressions and the port's own checked-in baseline.
"""

from .engine import LintConfig, lint_paths, load_baseline
from .rules import Finding, analyze_source
from .report import render_human, render_json

__all__ = [
    "Finding",
    "LintConfig",
    "analyze_source",
    "lint_paths",
    "load_baseline",
    "render_human",
    "render_json",
]
