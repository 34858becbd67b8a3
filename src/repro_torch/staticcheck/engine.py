"""File walking, inline suppressions, and the checked-in baseline.

Suppression syntax, on the flagged line::

    x = float(j_best)  # viem: noqa[VIEM001] host boundary: final readback

Everything after the closing bracket is the justification; ``viem lint``
refuses a bare suppression in ``--require-justification`` mode (the CI
default) so every exemption carries its one-line why.

The baseline file (the port's own, ``src/repro_torch/staticcheck/
baseline.txt``; the root ``staticcheck_baseline.txt`` is the JAX
package's) holds one finding fingerprint per line; findings present in
it are reported as suppressed ("baselined") without touching the source.
An empty baseline is the goal state and what this repo checks in.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from .rules import RULE_IDS, Finding, analyze_source

_NOQA_RE = re.compile(
    r"#\s*viem:\s*noqa\[([A-Z0-9,\s]+)\]\s*(.*)$")

DEFAULT_EXCLUDE = ("experiments", "__pycache__", ".git")


# the port's tree and its baseline, relative to the repo root
DEFAULT_PATHS = ("src/repro_torch",)
DEFAULT_BASELINE = "src/repro_torch/staticcheck/baseline.txt"


@dataclass
class LintConfig:
    paths: tuple[str, ...] = DEFAULT_PATHS
    rules: tuple[str, ...] = RULE_IDS
    baseline: str | None = None
    require_justification: bool = True
    exclude: tuple[str, ...] = DEFAULT_EXCLUDE


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    files_checked: int = 0

    @property
    def active(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def unjustified(self) -> list[Finding]:
        return [f for f in self.suppressed
                if not f.justification.strip()]


def parse_suppressions(source: str) -> dict[int, tuple[set[str], str]]:
    """line number -> (rule ids, justification text)."""
    out: dict[int, tuple[set[str], str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = (rules, m.group(2).strip())
    return out


def load_baseline(path: str | Path) -> set[str]:
    p = Path(path)
    if not p.exists():
        return set()
    return {line.strip() for line in p.read_text().splitlines()
            if line.strip() and not line.startswith("#")}


def lint_source(source: str, relpath: str,
                rules: tuple[str, ...] = RULE_IDS,
                baseline: set[str] | None = None) -> list[Finding]:
    findings = analyze_source(source, relpath, rules)
    noqa = parse_suppressions(source)
    baseline = baseline or set()
    for f in findings:
        entry = noqa.get(f.line)
        if entry is not None and f.rule in entry[0]:
            f.suppressed = True
            f.justification = entry[1]
        elif f.fingerprint() in baseline:
            f.suppressed = True
            f.justification = "baselined"
    return findings


def iter_python_files(paths: tuple[str, ...], root: Path,
                      exclude: tuple[str, ...]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        base = (root / p) if not Path(p).is_absolute() else Path(p)
        if base.is_file() and base.suffix == ".py":
            files.append(base)
            continue
        for f in sorted(base.rglob("*.py")):
            if any(part in exclude for part in f.parts):
                continue
            files.append(f)
    return files


def lint_paths(config: LintConfig, root: str | Path = ".") -> LintResult:
    root = Path(root)
    baseline = load_baseline(root / config.baseline) \
        if config.baseline else set()
    result = LintResult()
    for f in iter_python_files(config.paths, root, config.exclude):
        try:
            source = f.read_text()
        except (OSError, UnicodeDecodeError):
            continue
        rel = f.relative_to(root).as_posix() if f.is_relative_to(root) \
            else f.as_posix()
        result.findings.extend(
            lint_source(source, rel, config.rules, baseline))
        result.files_checked += 1
    return result


def write_baseline(result: LintResult, path: str | Path) -> int:
    """Snapshot every active finding's fingerprint; returns the count."""
    fps = sorted({f.fingerprint() for f in result.active})
    text = ("# viem lint baseline — one fingerprint per accepted "
            "finding.\n# Regenerate: python -m repro_torch.staticcheck "
            "--update-baseline\n" + "\n".join(fps))
    Path(path).write_text(text + "\n")
    return len(fps)
