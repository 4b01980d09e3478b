"""Resilience-aware simulation: so far its seeded fault traces only.

``faults.py`` is carried from the reference because the fleet simulator's
replica fault injection (``FleetSpec.faults``) draws from it.  The
resilience simulator itself (``report.py``, ``sim.py``, ``timeline.py``) is
ROADMAP queue A item 3.
"""
from repro_torch.resilience.faults import KINDS, FailureEvent, FailureGen

__all__ = ["KINDS", "FailureEvent", "FailureGen"]
