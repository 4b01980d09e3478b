"""Correctness tooling for the Charon port (``repro_torch``).

Two layers:

* :mod:`repro_torch.analysis.lint` — charon-lint, an AST-based static analyzer
  (stdlib ``ast`` only) encoding the repo-specific invariants R1-R5; run it
  as ``python -m repro_torch.analysis.lint src/``.
* :mod:`repro_torch.analysis.sanitize` — runtime cache-poisoning detector
  (``CHARON_SANITIZE=1`` / ``Simulator(sanitize=True)``) and the
  :func:`check_determinism` harness.

This package must stay importable without torch: the lint CLI runs in a bare
CI job.  Keep heavy imports inside :mod:`repro_torch.analysis.sanitize`.
"""
from __future__ import annotations

__all__ = ["lint", "sanitize"]
