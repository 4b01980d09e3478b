"""Resilience-aware simulation: fault injection, checkpoint pricing, and
goodput under MTBF.

Attach a :class:`~repro_torch.api.spec.ResilienceSpec` to a ``TrainWorkload``
and run it through :class:`ResilienceSimulator`; sweep checkpoint interval
x MTBF x spares with ``sweep(space, objective="goodput_under_failures")``.
See ``docs/resilience.md``.
"""
from repro_torch.resilience.faults import KINDS, FailureEvent, FailureGen
from repro_torch.resilience.report import ResilienceReport
from repro_torch.resilience.sim import ResilienceSimulator
from repro_torch.resilience.timeline import ReplayStats, replay

__all__ = [
    "KINDS", "FailureEvent", "FailureGen", "ReplayStats",
    "ResilienceReport", "ResilienceSimulator", "replay",
]
