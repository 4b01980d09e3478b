"""Discrete-event core: a time-ordered queue with deterministic ties.

Five event kinds drive the serving simulation: request ``ARRIVAL`` into a
pool's queue (from the workload, or from a prefill pool migrating a request
to its decode pool), ``STEP_DONE`` (an engine iteration priced by the
step oracle completes), and — fleet runs only — ``AUTOSCALE`` (the
autoscaler samples queue depths and may grow or shrink the serving set),
``FAILURE`` (a replica's seeded fault process fires: its in-flight work is
lost and its requests reroute) and ``RECOVER`` (a failed replica rejoins).
Ties at equal timestamps break by insertion order (a monotone sequence
number), so runs are bit-reproducible.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

ARRIVAL = "arrival"
STEP_DONE = "step_done"
AUTOSCALE = "autoscale"
FAILURE = "failure"
RECOVER = "recover"


@dataclass(frozen=True)
class Event:
    time: float
    seq: int
    kind: str
    payload: tuple = field(default=())


class EventQueue:
    def __init__(self):
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0

    def push(self, time: float, kind: str, payload: tuple = ()) -> Event:
        ev = Event(float(time), self._seq, kind, payload)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
