"""Typed spec API: one declarative surface for train, inference and serving.

    from repro_torch.api import (Cluster, DecodeWorkload, SimSpec, SweepSpace,
                                 TrainWorkload, sweep)
    from repro_torch.core import Simulator

    spec = SimSpec(model=cfg, cluster=Cluster("h100_sxm"),
                   workload=TrainWorkload(global_batch=8, seq_len=2048))
    report = Simulator("h100_sxm").run(spec)

A ``ServingWorkload`` spec runs through
``repro_torch.serving.sim.ServingSimulator(sim).run(spec)``; a
``SweepSpace`` over any spec fields runs through ``sweep(space)``.
"""
from repro_torch.api.spec import (
    STEP_WORKLOADS, AutoscalerSpec, CharonDeprecationWarning, CheckpointSpec,
    Cluster, DecodeWorkload, FaultModel, FleetSpec, PrefillWorkload,
    ReplicaFaultSpec, ResilienceSpec, RouterSpec, ServingWorkload, SimSpec,
    TrainWorkload,
)
from repro_torch.api.sweep import SweepSpace, spec_replace, sweep

__all__ = [
    "STEP_WORKLOADS", "AutoscalerSpec", "CharonDeprecationWarning",
    "CheckpointSpec", "Cluster", "DecodeWorkload", "FaultModel", "FleetSpec",
    "PrefillWorkload", "ReplicaFaultSpec", "ResilienceSpec", "RouterSpec",
    "ServingWorkload", "SimSpec", "TrainWorkload",
    "SweepSpace", "spec_replace", "sweep",
]
