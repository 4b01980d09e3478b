"""Request-level serving simulator (discrete-event continuous batching).

Layers a discrete-event request/queueing model on top of the core
:class:`~repro_torch.core.simulator.Simulator`: workloads (synthetic or
trace-driven) flow through pluggable batching policies; every engine
iteration is priced by the step-time oracle and the event loop aggregates
TTFT/TPOT/goodput into a :class:`ServingReport`.  The fleet layer
(:class:`FleetSimulator`) runs N replica engines behind a router with
optional autoscaling and aggregates a :class:`FleetReport`.  See
``docs/serving.md``.
"""
from repro_torch.serving.sim.events import (
    ARRIVAL, AUTOSCALE, STEP_DONE, Event, EventQueue,
)
from repro_torch.serving.sim.oracle import StepOracle, pow2_bucket
from repro_torch.serving.sim.policies import (
    ChunkedPrefill, ContinuousBatching, DecodeOnly, DisaggregatedPD,
    PrefillOnly, StaticBatching, StepPlan,
)
from repro_torch.serving.sim.report import (
    SLO, FleetReport, Percentiles, ServingReport,
)
from repro_torch.serving.sim.router import (
    Autoscaler, LeastLoadedRouter, RoundRobinRouter, SessionAffinityRouter,
    make_router,
)
from repro_torch.serving.sim.sim import (
    FleetSimulator, Pool, ReplicaPool, ServingScenario, ServingSimulator,
    make_pools, price_step_s,
)
from repro_torch.serving.sim.workload import (
    LengthDist, SimRequest, VirtualClock, Workload, synthesize, wall_clock,
)

__all__ = [
    "ARRIVAL", "AUTOSCALE", "STEP_DONE", "Event", "EventQueue",
    "StepOracle", "pow2_bucket",
    "ChunkedPrefill", "ContinuousBatching", "DecodeOnly", "DisaggregatedPD",
    "PrefillOnly", "StaticBatching", "StepPlan",
    "SLO", "FleetReport", "Percentiles", "ServingReport",
    "Autoscaler", "LeastLoadedRouter", "RoundRobinRouter",
    "SessionAffinityRouter", "make_router",
    "FleetSimulator", "Pool", "ReplicaPool", "ServingScenario",
    "ServingSimulator", "make_pools", "price_step_s",
    "LengthDist", "SimRequest", "VirtualClock", "Workload", "synthesize",
    "wall_clock",
]
