"""MetricsRegistry: one snapshot-and-diff surface for simulator telemetry.

Before this module every subsystem kept its own ad-hoc stats dict —
``Simulator.cache_stats()`` (nested per-layer hit/miss), the step oracle's
serving-bucket delta, ``ingest_extrapolation_stats()``, sweep configs/sec —
and every consumer re-implemented "snapshot before, subtract after".  The
registry unifies them:

* **counters** — monotonically increasing floats (``inc``), or absolute
  gauges adopted from an existing nested stats dict (``update_nested`` /
  ``update_from_simulator``), flattened to dotted names
  (``cache.pricing.hits``);
* **histograms** — streaming count/total/min/max (``observe``), e.g.
  per-candidate sweep wall time;
* **snapshot / diff** — ``snapshot()`` is a plain JSON-serializable dict;
  ``MetricsRegistry.diff(after, before)`` subtracts counters (and histogram
  counts/totals) so "what did this run cost" is one call regardless of
  which subsystem produced the numbers.

Attach one to a run (``ServingSimulator.run(..., metrics=reg)``,
``sweep(..., metrics=reg)``) and the snapshot lands in the report's
``metrics`` field / the sweep manifest's ``metrics`` section.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class HistStat:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def as_dict(self, nd: int = 6) -> dict:
        if not self.count:
            return {"count": 0, "total": 0.0, "mean": 0.0,
                    "min": 0.0, "max": 0.0}
        return {"count": self.count, "total": round(self.total, nd),
                "mean": round(self.total / self.count, nd),
                "min": round(self.min, nd), "max": round(self.max, nd)}


@dataclass
class MetricsRegistry:
    counters: dict = field(default_factory=dict)     # name -> float
    histograms: dict = field(default_factory=dict)   # name -> HistStat

    # ------------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        """Adopt an externally-maintained cumulative counter (a gauge)."""
        self.counters[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = HistStat()
        h.observe(value)

    # ------------------------------------------------------------------
    def update_nested(self, nested: dict, prefix: str = "") -> None:
        """Flatten a nested dict of numbers (``cache_stats()`` shape) into
        dotted counter names; non-numeric leaves are skipped."""
        for k, v in nested.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                self.update_nested(v, name)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                self.counters[name] = float(v)

    def update_from_simulator(self, sim) -> None:
        """Adopt every stats surface a core Simulator exposes: the layered
        cache counters (incl. oracle/serving hits and engine pricing) plus
        the module-level batch-extrapolation tallies."""
        from repro_torch.core.model_ingest import ingest_extrapolation_stats
        self.update_nested(sim.cache_stats(), "cache")
        self.update_nested(ingest_extrapolation_stats(), "ingest_extrap")

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        return {"counters": dict(self.counters),
                "histograms": {k: h.as_dict()
                               for k, h in self.histograms.items()}}

    @staticmethod
    def diff(after: dict, before: dict) -> dict:
        """Delta of two :meth:`snapshot` dicts: counters subtract (keys
        absent before count from zero); histograms subtract count/total and
        keep the after-side min/max."""
        bc = before.get("counters", {})
        counters = {k: v - bc.get(k, 0.0)
                    for k, v in after.get("counters", {}).items()}
        bh = before.get("histograms", {})
        hists = {}
        for k, h in after.get("histograms", {}).items():
            b = bh.get(k, {})
            hists[k] = {"count": h["count"] - b.get("count", 0),
                        "total": round(h["total"] - b.get("total", 0.0), 6),
                        "min": h["min"], "max": h["max"]}
        return {"counters": counters, "histograms": hists}
