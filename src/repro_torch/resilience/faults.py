"""Deterministic failure traces from seeded MTBF renewal processes.

Every component (chip, host, link) is an independent renewal process: its
inter-failure gaps are drawn from its own ``random.Random`` stream, seeded
by splitmix64-mixing the fault model's seed with the component's class and
index.  The merged trace is therefore a pure function of
``(FaultModel, component counts)`` — independent of Python hash
randomization, of how far the consumer reads, and crucially of the
checkpoint schedule: failures happen in wall-clock time whether or not the
job checkpoints, so a checkpoint-interval sweep replays the *same* trace.

The generator is lazy (a heap of per-component next-failure times), so the
horizon never needs to be known up front — the resilience timeline just
pulls failures until the run completes.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from random import Random

from repro_torch.api.spec import FaultModel

KINDS = ("chip", "host", "link")


def _mix(*parts: int) -> int:
    """splitmix64 over the parts — stable across processes and platforms
    (same construction as the serving router's rendezvous hash)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h ^= (p & 0xFFFFFFFFFFFFFFFF) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 27
        h *= 0x94D049BB133111EB
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


@dataclass(frozen=True)
class FailureEvent:
    """One component failure at wall-clock ``t_s``."""
    t_s: float
    kind: str       # chip | host | link
    index: int      # component index within its class

    def asdict(self) -> dict:
        return {"t_s": self.t_s, "kind": self.kind, "index": self.index}


class _Stream:
    """One component's renewal process."""

    __slots__ = ("rng", "draw")

    def __init__(self, model: FaultModel, kind: str, index: int,
                 mtbf_s: float):
        self.rng = Random(_mix(model.seed, KINDS.index(kind) + 1, index))
        if model.dist == "weibull":
            # scale so the mean stays at the configured MTBF:
            # E[Weibull(scale, k)] = scale * Gamma(1 + 1/k)
            scale = mtbf_s / math.gamma(1.0 + 1.0 / model.weibull_shape)
            k = model.weibull_shape
            self.draw = lambda: self.rng.weibullvariate(scale, k)
        else:
            rate = 1.0 / mtbf_s
            self.draw = lambda: self.rng.expovariate(rate)


class FailureGen:
    """Lazy merged failure trace over all components of a fault model.

    ``peek()`` returns the next failure time (``inf`` when the model is
    inactive); ``pop()`` consumes it and schedules that component's next
    renewal.  Ties break deterministically by (time, class, index).
    """

    def __init__(self, model: FaultModel, *, n_chips: int, n_hosts: int,
                 n_links: int):
        self._heap: list[tuple[float, int, int]] = []
        self._streams: dict[tuple[int, int], _Stream] = {}
        counts = {"chip": n_chips, "host": n_hosts, "link": n_links}
        for ki, kind in enumerate(KINDS):
            mtbf = getattr(model, f"{kind}_mtbf_s")
            if not 0 < mtbf < math.inf:
                continue
            for idx in range(counts[kind]):
                s = _Stream(model, kind, idx, mtbf)
                self._streams[(ki, idx)] = s
                heapq.heappush(self._heap, (s.draw(), ki, idx))

    def peek(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def pop(self) -> FailureEvent:
        t, ki, idx = heapq.heappop(self._heap)
        heapq.heappush(self._heap,
                       (t + self._streams[(ki, idx)].draw(), ki, idx))
        return FailureEvent(t, KINDS[ki], idx)


def replica_fault_stream(spec, index: int):
    """Lazy inter-failure gap stream for one serving replica.

    Returns a zero-arg callable yielding successive up-time gaps (seconds
    between recovery and the next failure).  The stream depends only on
    ``(spec.seed, index)`` — not on traffic or the rest of the fleet — so
    fleet fault traces are bit-deterministic.  ``spec`` is a
    :class:`~repro_torch.api.spec.ReplicaFaultSpec`.
    """
    rng = Random(_mix(spec.seed, 101, index))
    if spec.dist == "weibull":
        scale = spec.mtbf_s / math.gamma(1.0 + 1.0 / spec.weibull_shape)
        k = spec.weibull_shape
        return lambda: rng.weibullvariate(scale, k)
    rate = 1.0 / spec.mtbf_s
    return lambda: rng.expovariate(rate)
