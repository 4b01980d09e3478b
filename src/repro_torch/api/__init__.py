"""Typed spec API: one declarative surface for train and inference steps.

    from repro_torch.api import Cluster, DecodeWorkload, SimSpec, TrainWorkload
    from repro_torch.core import Simulator

    spec = SimSpec(model=cfg, cluster=Cluster("h100_sxm"),
                   workload=TrainWorkload(global_batch=8, seq_len=2048))
    report = Simulator("h100_sxm").run(spec)

Sweeps (``SweepSpace``, ``sweep``) and the serving specs are not ported yet
(ROADMAP queue A items 7 and 8).
"""
from repro_torch.api.spec import (
    STEP_WORKLOADS, CharonDeprecationWarning, CheckpointSpec, Cluster, DecodeWorkload,
    FaultModel, PrefillWorkload, ResilienceSpec, SimSpec, TrainWorkload,
)

__all__ = [
    "STEP_WORKLOADS", "CharonDeprecationWarning", "CheckpointSpec", "Cluster",
    "DecodeWorkload", "FaultModel", "PrefillWorkload", "ResilienceSpec", "SimSpec",
    "TrainWorkload",
]
