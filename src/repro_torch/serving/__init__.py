from repro_torch.serving.engine import Request, ServingEngine, VirtualClock

__all__ = ["Request", "ServingEngine", "VirtualClock"]
