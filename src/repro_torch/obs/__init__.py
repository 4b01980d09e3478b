"""Unified observability layer: tracing, metrics and attribution.

Three pieces, shared by every Charon simulator (core step, serving, fleet,
resilience) and the sweep engine — see ``docs/observability.md``:

* :class:`TraceRecorder` / :data:`NULL_RECORDER` — span/instant/counter
  events merged into one Perfetto/chrome JSON; the null object keeps the
  recorder-off hot paths at a single branch per event.
* :class:`MetricsRegistry` — counters + histograms with a snapshot-and-diff
  API that unifies the scattered ``cache_stats()`` / oracle-hit /
  extrapolation dicts.
* ``explain()`` attribution (:mod:`repro_torch.obs.explain`) — critical paths,
  top-k ops, compute-vs-comm decomposition, SLO-violation causes; surfaced
  as ``Report.explain()`` / ``ServingReport.explain()`` and in sweep
  manifest rows.
"""
from repro_torch.obs.explain import (
    compact_report, compact_resilience, compact_serving, critical_path,
    explain_report, explain_serving, render_report, render_serving,
)
from repro_torch.obs.metrics import HistStat, MetricsRegistry
from repro_torch.obs.recorder import CNAMES, NULL_RECORDER, NullRecorder, TraceRecorder

__all__ = [
    "CNAMES", "NULL_RECORDER", "NullRecorder", "TraceRecorder",
    "HistStat", "MetricsRegistry",
    "compact_report", "compact_resilience", "compact_serving",
    "critical_path", "explain_report", "explain_serving",
    "render_report", "render_serving",
]
