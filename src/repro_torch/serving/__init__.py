from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sim import (
    SLO, ServingReport, ServingScenario, ServingSimulator, StepOracle,
    VirtualClock, Workload, synthesize,
)
from repro_torch.serving.sp_planner import (
    BatchPlan, SPChoice, attention_latency_us, plan_batch, plan_request,
)

__all__ = ["Request", "ServingEngine", "BatchPlan", "SPChoice",
           "attention_latency_us", "plan_batch", "plan_request",
           "SLO", "ServingReport", "ServingScenario", "ServingSimulator",
           "StepOracle", "VirtualClock", "Workload", "synthesize"]
