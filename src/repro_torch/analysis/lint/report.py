"""Finding and report types for charon-lint.

A :class:`Finding` is one rule violation at one source location; a
:class:`LintReport` aggregates findings across a run, splitting them into
*active* findings (fail the build) and *disabled* findings (suppressed by an
inline ``# charon-lint: disable=RN`` comment).  Disabled findings never fail
the run but are counted loudly: every suppression is a standing claim that a
nondeterminism/aliasing pattern is safe, and the report surfaces the full
list so reviews re-litigate them instead of forgetting them.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``fixit`` is the rule's standing advice for repairing this class of
    finding (not a machine-applicable patch); ``disabled`` marks findings
    suppressed by an inline disable comment.
    """
    rule: str                   # "R1".."R5"
    title: str                  # rule short name
    path: str                   # path as scanned (normalized, posix)
    line: int
    message: str
    fixit: str = ""
    disabled: bool = False

    def render(self) -> str:
        mark = " [disabled]" if self.disabled else ""
        out = f"{self.path}:{self.line}: {self.rule}{mark}: {self.message}"
        if self.fixit and not self.disabled:
            out += f"\n    fix: {self.fixit}"
        return out

    def as_dict(self) -> dict:
        return {"rule": self.rule, "title": self.title, "path": self.path,
                "line": self.line, "message": self.message,
                "fixit": self.fixit, "disabled": self.disabled}


@dataclass
class LintReport:
    """All findings of one lint run plus scan bookkeeping."""
    findings: tuple = ()
    n_files: int = 0
    errors: tuple = ()          # (path, message) rows for unparseable files

    @property
    def active(self) -> tuple:
        return tuple(f for f in self.findings if not f.disabled)

    @property
    def disabled(self) -> tuple:
        return tuple(f for f in self.findings if f.disabled)

    @property
    def ok(self) -> bool:
        return not self.active and not self.errors

    def by_rule(self) -> dict:
        out: dict[str, int] = {}
        for f in self.active:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def render(self) -> str:
        lines: list[str] = []
        for path, msg in self.errors:
            lines.append(f"{path}: parse error: {msg}")
        for f in sorted(self.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            lines.append(f.render())
        counts = self.by_rule()
        summary = ", ".join(f"{r}:{n}" for r, n in sorted(counts.items())) \
            or "none"
        lines.append(
            f"charon-lint: {self.n_files} files, "
            f"{len(self.active)} finding(s) [{summary}], "
            f"{len(self.disabled)} disabled suppression(s)")
        if self.disabled:
            # loud: every suppression is listed in the summary line block
            for f in self.disabled:
                lines.append(f"  suppressed: {f.path}:{f.line} {f.rule} "
                             f"({f.title})")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {"n_files": self.n_files,
                "n_active": len(self.active),
                "n_disabled": len(self.disabled),
                "by_rule": self.by_rule(),
                "errors": [list(e) for e in self.errors],
                "findings": [f.as_dict() for f in self.findings]}

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=1, sort_keys=True)
