"""Human and JSON renderings of a lint + runtime-audit run."""

from __future__ import annotations

import json

from .engine import LintResult

_RULE_TITLES = {
    "VIEM000": "syntax error",
    "VIEM001": "host-sync hazard in device module",
    "VIEM002": "reserved (retrace hazard; the port compiles nothing "
               "per call)",
    "VIEM003": "Python control flow on a tensor",
    "VIEM004": "lock discipline",
}


def render_human(result: LintResult, audit: dict | None = None,
                 verbose: bool = False) -> str:
    lines: list[str] = []
    for f in result.active:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet}")
    if verbose and result.suppressed:
        lines.append("")
        lines.append("suppressed:")
        for f in result.suppressed:
            why = f.justification or "(no justification)"
            lines.append(f"  {f.path}:{f.line}: {f.rule} — {why}")
    lines.append("")
    by_rule: dict[str, int] = {}
    for f in result.findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items())) \
        or "none"
    lines.append(
        f"viem lint: {result.files_checked} files, "
        f"{len(result.active)} active finding(s), "
        f"{len(result.suppressed)} suppressed ({summary})")
    if audit is not None:
        ok = sum(1 for e in audit["entries"] if e["status"] == "ok")
        skipped = sum(1 for e in audit["entries"]
                      if e["status"] == "skipped")
        failed = [e for e in audit["entries"] if e["status"] == "failed"]
        lines.append(
            f"runtime audit ({audit['device']}): {ok} ran clean, "
            f"{skipped} skipped (incompatible combos), "
            f"{len(failed)} failed")
        for e in failed:
            lines.append(f"  FAIL {e['construction']} x {e['topology']}: "
                         f"{'; '.join(e['problems'])}")
    return "\n".join(lines)


def render_json(result: LintResult, audit: dict | None = None) -> str:
    doc = {
        "files_checked": result.files_checked,
        "active": [f.to_dict() for f in result.active],
        "suppressed": [f.to_dict() for f in result.suppressed],
        "rules": _RULE_TITLES,
    }
    if audit is not None:
        doc["runtime_audit"] = audit
    return json.dumps(doc, indent=2, sort_keys=True)
