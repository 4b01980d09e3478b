"""Unified trace recording: one Perfetto/chrome JSON across all simulators.

Every Charon simulator — the core step simulator, the request-level serving
simulator, the fleet simulator and the resilience timeline — accepts a
``recorder=`` and emits its events into the same three primitives:

* ``span(pid, tid, name, start_s, dur_s)`` — a complete ("X") event on a
  lane, e.g. one engine iteration on a replica's pool, or a rework window
  on the resilience timeline;
* ``instant(pid, tid, name, ts_s)`` — a point ("i") event, e.g. a replica
  FAILURE, an autoscaler action, a KV-transfer migration, a sweep prune;
* ``counter(pid, name, ts_s, value)`` — a "C" series, e.g. queue depth.

Lanes are ``(pid, tid)`` string pairs — Perfetto groups tracks by pid — and
timestamps are *simulated seconds* (converted to the chrome convention of
microseconds at record time).  ``extend()`` adopts pre-built chrome events
(already in microseconds), which is how the core simulator's per-block
:func:`~repro_torch.core.timeline.to_chrome_trace` output merges into the same
file.

The default everywhere is :data:`NULL_RECORDER`, a null object whose
``enabled`` is False; hot event loops guard each emission with one
attribute check (``if rec.enabled:``), so the off-mode cost is a branch —
the recorder-off contract (bit-identical reports, <2% wall overhead on
bench_fleet) is asserted in tests and guarded in CI.
"""
from __future__ import annotations

import json
from pathlib import Path

# chrome-trace "cname" palette entries used for the resilience buckets —
# Perfetto ignores unknown names gracefully, chrome://tracing colors them
CNAMES = {"useful": "good", "rework": "bad", "downtime": "terrible",
          "checkpoint": "grey", "straggler": "yellow"}


class NullRecorder:
    """Zero-overhead default: every hook is a no-op.

    Simulators store whatever recorder they are given and guard hot-path
    emissions with ``if rec.enabled:`` — with this object that is a single
    false attribute test per event, and no argument tuples are ever built.
    """

    enabled = False

    def span(self, pid, tid, name, start_s, dur_s, *, cat="", args=None,
             cname=None):
        return None

    def instant(self, pid, tid, name, ts_s, *, cat="", args=None):
        return None

    def counter(self, pid, name, ts_s, value):
        return None

    def extend(self, events):
        return None

    def events(self):
        return []


NULL_RECORDER = NullRecorder()


class TraceRecorder(NullRecorder):
    """Collects span/instant/counter events and exports one merged
    Perfetto-loadable chrome JSON (see :meth:`write` / :meth:`to_json`).

    ``max_request_lanes`` caps how many per-request lanes the serving
    simulators emit (a 100k-request trace would otherwise create 100k
    tracks); per the no-silent-caps rule the simulators emit a
    ``request_lanes_dropped`` metadata instant — and bump the matching
    metrics counter — whenever the cap bites.
    """

    enabled = True

    def __init__(self, *, max_request_lanes: int = 64):
        self.max_request_lanes = max_request_lanes
        self._events: list[dict] = []

    # ------------------------------------------------------------------
    def span(self, pid, tid, name, start_s, dur_s, *, cat="", args=None,
             cname=None):
        ev = {"name": name, "ph": "X", "ts": start_s * 1e6,
              "dur": max(dur_s, 0.0) * 1e6, "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if cname:
            ev["cname"] = cname
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def instant(self, pid, tid, name, ts_s, *, cat="", args=None):
        ev = {"name": name, "ph": "i", "s": "t", "ts": ts_s * 1e6,
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def counter(self, pid, name, ts_s, value):
        series = value if isinstance(value, dict) else {"value": value}
        self._events.append({"name": name, "ph": "C", "ts": ts_s * 1e6,
                             "pid": pid, "tid": name,
                             "args": {k: float(v) for k, v in series.items()}})

    def extend(self, events):
        """Adopt pre-built chrome events (timestamps already in us) — the
        bridge from :func:`~repro_torch.core.timeline.to_chrome_trace` /
        ``pp_trace`` output into the merged file."""
        self._events.extend(events)

    # ------------------------------------------------------------------
    def events(self) -> list[dict]:
        """All events, sorted by timestamp (ties keep insertion order) —
        the monotone-``ts`` form the exporter tests schema-validate."""
        return sorted(self._events, key=lambda e: e.get("ts", 0.0))

    def __len__(self) -> int:
        return len(self._events)

    def to_json(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path: str | Path) -> Path:
        """Write the merged trace; load the file in ui.perfetto.dev or
        chrome://tracing."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json()))
        return path
