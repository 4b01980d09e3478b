"""The one sanctioned wall clock for telemetry.

Simulated time comes from the event loops; hardware measurement time comes
from the measurement engines (``core/backend/profiling.py``,
``serving/sim/workload.py``).  Everything else that wants a wall-clock
reading — sweep progress lines, trace-lane epochs, wall_time_s telemetry —
must go through :func:`wall_s` so charon-lint rule R2 can ban ``time.time``
outright inside the deterministic scopes.

Epoch time (not a monotonic clock) is deliberate: sweep worker processes
stamp trace events independently, and only an epoch base lines their lanes
up in one merged Perfetto view.  Callers must never let these values feed
simulation results, cache keys, or report fields other than telemetry.
"""
from __future__ import annotations

import time


def wall_s() -> float:
    """Seconds since the epoch, for telemetry only (never simulation)."""
    return time.time()


def wall_span_s(t0: float) -> float:
    """Elapsed seconds since *t0* (a prior :func:`wall_s` reading)."""
    return time.time() - t0
