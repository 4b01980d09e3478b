"""Chrome-trace export: PyTorch-profiler-style timelines (paper §3.2c).

``to_chrome_trace`` emits a single-rank timeline; ``pp_trace`` emits the 3D
multi-GPU view (pid = "dp{i}|pp{j}", tid = stream) from a PPSchedule plus
per-rank op timelines; ``record_report`` pushes a whole core
:class:`~repro_torch.core.simulator.Report` (every block timeline + the pipeline
schedule) into a :class:`~repro_torch.obs.TraceRecorder`, which is how core-step
runs join the unified observability trace.  Load the JSON in
chrome://tracing or Perfetto.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.passes.pipeline import PPSchedule
from repro_torch.core.scheduler import Timeline

_CAT = {"matmul": "compute", "attention": "compute", "fused": "compute",
        "norm": "compute", "elementwise": "compute", "softmax": "compute",
        "reduce": "compute", "all_reduce": "comm", "all_gather": "comm",
        "reduce_scatter": "comm", "all_to_all": "comm", "send": "comm",
        "recv": "comm", "collective_permute": "comm"}


def to_chrome_trace(tl: Timeline, *, pid: str = "rank0",
                    expand_limit: int = 20000, metrics=None) -> list[dict]:
    """Timeline -> chrome events.  Timelines beyond ``expand_limit``
    intervals are truncated, *loudly*: a trailing metadata instant carries
    the dropped count (and a ``trace.dropped_intervals`` counter is bumped
    on ``metrics`` when one is given) — no silent caps."""
    events = []
    for iv in tl.intervals[:expand_limit]:
        events.append({
            "name": iv.name, "cat": _CAT.get(iv.kind, "other"), "ph": "X",
            "ts": iv.start, "dur": iv.dur, "pid": pid, "tid": iv.stream,
            "args": {"kind": iv.kind, "phase": iv.phase, "engine": iv.engine,
                     "repeat": iv.repeat, "comm_bytes": iv.comm_bytes},
        })
    dropped = len(tl.intervals) - expand_limit
    if dropped > 0:
        events.append({
            "name": "charon:trace_truncated", "cat": "meta", "ph": "i",
            "s": "p", "ts": events[-1]["ts"] + events[-1]["dur"],
            "pid": pid, "tid": "meta",
            "args": {"dropped_intervals": dropped,
                     "expand_limit": expand_limit,
                     "total_intervals": len(tl.intervals)},
        })
        if metrics is not None:
            metrics.inc("trace.dropped_intervals", dropped)
    return events


def pp_trace(sched: PPSchedule, *, dp_rank: int = 0) -> list[dict]:
    events = []
    for e in sched.events:
        events.append({
            "name": f"{e.kind}{e.microbatch}", "cat": "pp", "ph": "X",
            "ts": e.start, "dur": e.end - e.start,
            "pid": f"dp{dp_rank}|pp{e.rank}", "tid": "pipeline",
            "args": {"microbatch": e.microbatch, "kind": e.kind},
        })
    return events


def record_report(recorder, report, *, pid: str = "core",
                  expand_limit: int = 20000, metrics=None) -> None:
    """Push a core step report's timelines into a recorder: one lane group
    per block kind (``pid/<kind>``) plus the pipeline schedule when the
    report has one.  Requires a report produced with
    ``keep_timelines=True`` — without timelines there is nothing to record
    (``Simulator.run(spec, recorder=...)`` arranges this automatically)."""
    if not recorder.enabled:
        return
    for kind, tl in report.block_timelines.items():
        recorder.extend(to_chrome_trace(tl, pid=f"{pid}/{kind}",
                                        expand_limit=expand_limit,
                                        metrics=metrics))
    if report.pp is not None:
        recorder.extend(pp_trace(report.pp))


def merge_traces(*event_lists: list[dict]) -> list[dict]:
    """Merge chrome event lists into one, sorted by timestamp (stable, so
    equal timestamps keep their per-source order)."""
    out = [e for evs in event_lists for e in evs]
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out


def write_trace(events: list[dict], path: str | Path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events,
                                "displayTimeUnit": "ms"}))
    return path
