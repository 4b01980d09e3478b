from repro_torch.core.passes.base import ParallelConfig, PassContext, PassManager
from repro_torch.core.passes.data_parallel import DataParallelPass, optimizer_step_cost
from repro_torch.core.passes.fusion import FusionPass, FusionRule
from repro_torch.core.passes.parallelism import (
    ContextParallelPass, ExpertParallelPass, SequenceParallelPass,
    TensorParallelPass,
)
from repro_torch.core.passes.pipeline import PPSchedule, make_schedule
from repro_torch.core.passes.quantize import QuantizePass
from repro_torch.core.passes.recompute import RecomputePass

__all__ = [
    "ParallelConfig", "PassContext", "PassManager", "DataParallelPass",
    "optimizer_step_cost", "FusionPass", "FusionRule", "ContextParallelPass",
    "ExpertParallelPass", "SequenceParallelPass", "TensorParallelPass",
    "PPSchedule", "make_schedule", "QuantizePass", "RecomputePass",
]
