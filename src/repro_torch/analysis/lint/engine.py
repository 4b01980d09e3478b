"""charon-lint engine: parse files, run rules, apply disable comments.

The engine is deliberately tiny — rules do the real work.  It owns three
jobs:

* walking the requested paths and parsing each ``.py`` file once into a
  :class:`ParsedModule` (AST + raw lines + parent links),
* normalizing paths so rule *scopes* ("core/", "serving/sim/", ...) match
  both the real tree (``src/repro_torch/core/overlap.py``) and test fixtures laid
  out under a temp dir (``<tmp>/core/bad.py``),
* honoring inline ``# charon-lint: disable=R2`` / ``disable=R1,R4``
  comments: a finding whose line (or whose statement's first line) carries a
  matching disable marker is demoted to *disabled* — reported and counted,
  never failing the run.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from .report import Finding, LintReport

_DISABLE_RE = re.compile(r"#\s*charon-lint:\s*disable=([A-Z0-9,\s]+)")

# path components stripped from the left so rule scopes are package-relative
_STRIP_PREFIXES = ("src", "repro", "repro_torch")


def _normalize_rel(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.parts)
    while parts and parts[0] in _STRIP_PREFIXES:
        parts.pop(0)
    return "/".join(parts)


def parse_disables(lines: list) -> dict:
    """Map 1-based line number -> set of rule IDs disabled on that line."""
    out: dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _DISABLE_RE.search(line)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out[i] = rules
    return out


@dataclass
class ParsedModule:
    """One parsed source file handed to every rule."""
    path: Path                  # real filesystem path
    rel: str                    # scope-normalized posix-ish relative path
    tree: ast.AST
    lines: list
    disables: dict = field(default_factory=dict)

    def __post_init__(self):
        # parent links let rules look outward from a node (e.g. "is this
        # id() call inside a subscript key?") without threading state.
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._charon_parent = node  # type: ignore[attr-defined]

    def in_scope(self, scopes) -> bool:
        """True if this module falls under any of the given scope prefixes.

        A scope ending in ``/`` is a directory prefix; otherwise an exact
        file match.  ``()`` means all files.
        """
        if not scopes:
            return True
        for s in scopes:
            if s.endswith("/"):
                if self.rel.startswith(s):
                    return True
            elif self.rel == s:
                return True
        return False

    def disabled_at(self, line: int, rule: str) -> bool:
        rules = self.disables.get(line)
        return bool(rules) and rule in rules


def parent(node: ast.AST):
    return getattr(node, "_charon_parent", None)


def iter_py_files(paths):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def run_lint(paths, rules=None, root: Path | None = None) -> LintReport:
    """Lint every ``.py`` under *paths* with *rules* (default: all).

    *root* anchors path normalization; defaults to the common parent so
    fixture trees behave like the real one.
    """
    from .rules import ALL_RULES
    rules = list(rules) if rules is not None else [cls() for cls in ALL_RULES]

    files = list(iter_py_files(paths))
    if root is None:
        root = Path(paths[0]) if files else Path(".")
        if root.is_file():
            root = root.parent
    findings: list[Finding] = []
    errors: list = []
    for path in files:
        try:
            text = path.read_text()
            tree = ast.parse(text, filename=str(path))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append((str(path), str(e)))
            continue
        lines = text.splitlines()
        mod = ParsedModule(path=path, rel=_normalize_rel(path, root),
                           tree=tree, lines=lines,
                           disables=parse_disables(lines))
        for rule in rules:
            if not mod.in_scope(rule.scopes):
                continue
            for f in rule.check(mod):
                if mod.disabled_at(f.line, f.rule):
                    f = Finding(**{**f.as_dict(), "disabled": True})
                findings.append(f)
    return LintReport(findings=tuple(findings), n_files=len(files),
                      errors=tuple(errors))
