"""charon-lint: AST-based static analysis for Charon-specific invariants."""
from __future__ import annotations

from .engine import ParsedModule, run_lint
from .report import Finding, LintReport
from .rules import ALL_RULES, RULES_BY_ID

__all__ = ["ParsedModule", "run_lint", "Finding", "LintReport",
           "ALL_RULES", "RULES_BY_ID", "main"]


def main(argv=None) -> int:
    from .__main__ import main as _main
    return _main(argv)
