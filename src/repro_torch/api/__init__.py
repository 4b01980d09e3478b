"""Typed spec API: one declarative surface for train, inference and serving.

    from repro_torch.api import Cluster, DecodeWorkload, SimSpec, TrainWorkload
    from repro_torch.core import Simulator

    spec = SimSpec(model=cfg, cluster=Cluster("h100_sxm"),
                   workload=TrainWorkload(global_batch=8, seq_len=2048))
    report = Simulator("h100_sxm").run(spec)

A ``ServingWorkload`` spec runs through
``repro_torch.serving.sim.ServingSimulator(sim).run(spec)``.  Sweeps
(``SweepSpace``, ``sweep``) are not ported yet (ROADMAP queue A item 4).
"""
from repro_torch.api.spec import (
    STEP_WORKLOADS, AutoscalerSpec, CharonDeprecationWarning, CheckpointSpec,
    Cluster, DecodeWorkload, FaultModel, FleetSpec, PrefillWorkload,
    ReplicaFaultSpec, ResilienceSpec, RouterSpec, ServingWorkload, SimSpec,
    TrainWorkload,
)

__all__ = [
    "STEP_WORKLOADS", "AutoscalerSpec", "CharonDeprecationWarning",
    "CheckpointSpec", "Cluster", "DecodeWorkload", "FaultModel", "FleetSpec",
    "PrefillWorkload", "ReplicaFaultSpec", "ResilienceSpec", "RouterSpec",
    "ServingWorkload", "SimSpec", "TrainWorkload",
]
