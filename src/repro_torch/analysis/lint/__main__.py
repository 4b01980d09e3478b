"""CLI entry point: ``python -m repro_torch.analysis.lint src/``.

Exit status 0 iff there are no *active* findings and every file parsed.
Disabled findings (``# charon-lint: disable=RN``) never fail the run but
are counted loudly in the summary.
"""
from __future__ import annotations

import argparse
import sys

from .engine import run_lint
from .rules import ALL_RULES, RULES_BY_ID


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="charon-lint: enforce Charon repro invariants R1-R6")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to scan (e.g. src/)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rule IDs (default all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the report as JSON")
    args = ap.parse_args(argv)

    if args.rules:
        ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in ids if r not in RULES_BY_ID]
        if unknown:
            ap.error(f"unknown rule id(s): {', '.join(unknown)} "
                     f"(known: {', '.join(sorted(RULES_BY_ID))})")
        rules = [RULES_BY_ID[r]() for r in ids]
    else:
        rules = [cls() for cls in ALL_RULES]

    report = run_lint(args.paths, rules=rules)
    print(report.to_json() if args.as_json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
