"""``viem lint`` / ``python -m repro_torch.staticcheck`` — run the
invariant lint engine (and optionally the runtime audit) over the port.

Exit status: 0 when there are no active findings, no unjustified
suppressions (unless ``--no-require-justification``) and the audit (if
requested) is clean; 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .engine import DEFAULT_BASELINE, DEFAULT_PATHS, LintConfig, \
    lint_paths, write_baseline
from .report import render_human, render_json
from .rules import RULE_IDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="viem lint",
        description="repo-invariant static checks (VIEM001, VIEM003, "
                    "VIEM004) plus the runtime audit")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files or directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--rules", default=",".join(RULE_IDS),
                    help="comma-separated rule ids to enable")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file of accepted finding fingerprints")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current active "
                         "findings and exit 0")
    ap.add_argument("--no-require-justification", dest="require_just",
                    action="store_false", default=True,
                    help="allow bare `# viem: noqa[...]` suppressions "
                         "without a trailing justification")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="also write the machine-readable report here "
                         "('-' for stdout)")
    ap.add_argument("--runtime-audit", action="store_true",
                    help="run every registered construction x topology "
                         "through the plan's entry points under an op "
                         "recorder and audit the run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runtime audit runs (default cuda, as "
                         "every entry point of the port; no fallback)")
    ap.add_argument("--verbose", action="store_true",
                    help="list suppressed findings too")
    ap.add_argument("--root", default=".",
                    help="repo root for relative paths and the baseline")
    args = ap.parse_args(argv)

    config = LintConfig(
        paths=tuple(args.paths) or DEFAULT_PATHS,
        rules=tuple(r.strip() for r in args.rules.split(",") if r.strip()),
        baseline=args.baseline,
        require_justification=args.require_just,
    )
    result = lint_paths(config, root=args.root)

    if args.update_baseline:
        n = write_baseline(result, Path(args.root) / args.baseline)
        print(f"viem lint: baseline rewritten with {n} fingerprint(s)")
        return 0

    audit = None
    if args.runtime_audit:
        from .runtime_audit import run_audit
        audit = run_audit(device=args.device)

    if args.json:
        doc = render_json(result, audit)
        if args.json == "-":
            print(doc)                # machine output owns stdout
            print(render_human(result, audit, verbose=args.verbose),
                  file=sys.stderr)
        else:
            Path(args.json).write_text(doc + "\n")

    if args.json != "-":
        print(render_human(result, audit, verbose=args.verbose))

    failed = bool(result.active)
    if config.require_justification and result.unjustified:
        for f in result.unjustified:
            print(f"{f.path}:{f.line}: {f.rule} suppressed without a "
                  "justification — add one after the bracket")
        failed = True
    if audit is not None and not audit["ok"]:
        failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
