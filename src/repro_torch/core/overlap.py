"""Operator-overlap modeling (paper §3.4).

Two models:

* **ratio-based** — overlapped portions of compute and comm ops are slowed by
  calibrated per-hardware factors (separate factors for the compute and comm
  sides of compute<->comm overlap; a shared factor for comm<->comm).

* **bandwidth-aware** (fine-grained, comm<->comm under the analytical
  engine) — a progressive-filling fluid model: flows sharing a link domain
  split its effective bandwidth; per overlapped segment each flow advances at
  bw/n_active, reproducing packet-level congestion behaviour (paper Fig. 6).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.backend.hardware import HardwareSpec
from repro_torch.core.scheduler import Interval, Timeline


def _overlap(a: Interval, b: Interval) -> float:
    return max(0.0, min(a.end, b.end) - max(a.start, b.start))


def apply_ratio_overlap(tl: Timeline, hw: HardwareSpec) -> Timeline:
    """Ratio-based slowdown: only the overlapped fraction of an op is slowed
    (paper: 'the slowdown factor only applies to the portion overlapped')."""
    # Intervals are mutable (unhashable) objects, so slowdown accumulators
    # are keyed by timeline position — stable across runs and processes,
    # unlike the id()-keyed dicts this replaced.
    ivs = tl.intervals
    comp_idx = [i for i, iv in enumerate(ivs) if iv.stream == "compute"]
    comm_idx = [i for i, iv in enumerate(ivs) if iv.stream != "compute"]
    extra = [0.0] * len(ivs)
    for ci in comm_idx:
        c = ivs[ci]
        for ki in comp_idx:
            ov = _overlap(c, ivs[ki])
            if ov <= 0:
                continue
            extra[ki] += ov * (hw.overlap_slowdown_compute - 1.0)
            extra[ci] += ov * (hw.overlap_slowdown_comm - 1.0)
    for a, ci in enumerate(comm_idx):
        c1 = ivs[ci]
        for cj in comm_idx[a + 1:]:
            c2 = ivs[cj]
            if c1.stream == c2.stream:
                continue
            ov = _overlap(c1, c2)
            if ov <= 0:
                continue
            s = hw.overlap_slowdown_comm_comm - 1.0
            extra[ci] += ov * s
            extra[cj] += ov * s
    for i, iv in enumerate(ivs):
        iv.end += extra[i]
    return tl


def bandwidth_aware_comm(comm_intervals: list[Interval]) -> list[Interval]:
    """Progressive-filling fluid model for concurrent comm flows sharing one
    link domain.  Each flow carries ``comm_bytes`` and a standalone duration;
    rate alone = bytes/duration; with n concurrent flows every flow runs at
    rate/n (fair bandwidth competition).  Returns intervals with adjusted end
    times, preserving start order."""
    flows = sorted(comm_intervals, key=lambda i: i.start)
    if not flows:
        return []
    # flows are tracked by sorted position, not id(): indices are stable
    # across runs, so the fluid model is replayable bit-for-bit
    remaining = [max(f.comm_bytes, 1e-9) for f in flows]
    rate1 = [max(f.comm_bytes, 1e-9) / max(f.dur, 1e-9) for f in flows]
    finished: dict[int, float] = {}
    t = flows[0].start
    active: list[int] = []
    pending = list(range(len(flows)))
    while pending or active:
        while pending and flows[pending[0]].start <= t + 1e-12:
            active.append(pending.pop(0))
        if not active:
            t = flows[pending[0]].start
            continue
        n = len(active)
        # next event: a flow finishing or a new arrival
        t_finish = min(t + remaining[i] / (rate1[i] / n) for i in active)
        t_next = min(t_finish, flows[pending[0]].start) if pending \
            else t_finish
        dt = t_next - t
        if dt <= 0.0:
            # numerical stall: remaining/rate underflowed against t, so no
            # event advances the clock — finish the flow closest to done to
            # guarantee forward progress
            i = min(active, key=lambda i: remaining[i] / rate1[i])
            finished[i] = t
            active.remove(i)
            continue
        for i in list(active):
            remaining[i] -= rate1[i] / n * dt
            if remaining[i] <= 1e-9:
                finished[i] = t_next
                active.remove(i)
        t = t_next
    out = []
    for i, f in enumerate(flows):
        nf = Interval(f.name, f.kind, f.stream, f.start,
                      finished.get(i, f.end), f.phase, f.comm_group,
                      f.comm_bytes, f.repeat, f.engine)
        out.append(nf)
    return out


def apply_bandwidth_aware(tl: Timeline, hw: HardwareSpec) -> Timeline:
    """Replace comm intervals with fluid-model adjusted versions, then apply
    the ratio model for compute<->comm."""
    comm = [i for i in tl.intervals if i.stream != "compute"]
    rest = [i for i in tl.intervals if i.stream == "compute"]
    adjusted = bandwidth_aware_comm(comm)
    tl2 = Timeline(intervals=rest + adjusted)
    return apply_ratio_overlap(tl2, hw)
